"""Command-line entry points of the PyTorch port (`python -m
bark_tpu_torch.cli.<name>`): `main` (text -> WAV), `quantize`, `voice`,
`convert`, `server` (the HTTP server) and `precompile` (the warm-start
of a serving process). The ones that run the model take `--device`
(default `cuda`) and refuse to start when that device is missing."""


def device_error(device: str):
    """Why `device` cannot run the model, or None: a CUDA device needs a
    GPU that PyTorch sees, and a tool asked for one never falls back to
    the CPU (`--device cpu` runs the kernels' plain versions)."""
    import torch

    try:
        dev = torch.device(device)
    except RuntimeError as e:
        return f"bad --device {device!r}: {e}"
    if dev.type == "cuda" and not torch.cuda.is_available():
        return (f"--device {device}: no CUDA GPU is available (PyTorch "
                f"{torch.__version__}); pass --device cpu to run on the CPU")
    return None
