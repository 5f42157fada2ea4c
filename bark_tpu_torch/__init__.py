"""bark_tpu_torch — the PyTorch/CUDA port of bark_tpu.

The same text-to-speech pipeline (BERT WordPiece tokens -> semantic and
coarse autoregressive GPT stages with device-resident KV caches -> the
non-causal fine stage -> EnCodec decode to 24 kHz PCM) written in PyTorch,
with the TPU package's Pallas kernels replaced by hand-written CUDA kernels
for NVIDIA Hopper (`kernels/`, sources in `csrc/`). It imports torch and
nothing of jax or of bark_tpu: the model-file format, the block quantizers,
the tokenizer and the params are the port's own copies (`io/`, `text/`,
`params.py`), which tests/test_torch_shared_copies.py holds equal to
bark_tpu's.
"""

__version__ = "0.1.0"

from bark_tpu_torch.params import (  # noqa: F401
    BarkContextParams,
    EncodingStep,
    Verbosity,
    bark_context_default_params,
)

_API_NAMES = {
    "BarkContext",
    "bark_load_model",
    "bark_generate_audio",
    "bark_get_audio_data",
    "bark_get_audio_data_size",
    "bark_get_load_time",
    "bark_get_eval_time",
    "bark_reset_statistics",
    "bark_free",
    "bark_model_quantize",
    "bark_save_voice",
}


def __getattr__(name):
    # the API pulls in torch; tooling that only needs the params does not
    if name in _API_NAMES:
        from bark_tpu_torch.api import context as _ctx

        return getattr(_ctx, name)
    if name in ("VoicePreset", "load_voice_preset", "save_voice_preset"):
        from bark_tpu_torch.pipeline import voice as _voice

        return getattr(_voice, name)
    raise AttributeError(f"module 'bark_tpu_torch' has no attribute '{name}'")
