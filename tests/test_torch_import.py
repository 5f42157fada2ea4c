"""The PyTorch port imports torch and never jax, and nothing of bark_tpu:
every bark_tpu_torch module is imported in a fresh interpreter, and the
CPU API runs there on a tiny model file (dense and packed, and the batched
`generate_audio_batch` on the dense one), and neither
jax nor any bark_tpu module may show up in sys.modules (the machine with
the GPU has no jax). No source line of the port or of chip_smoke.py
imports bark_tpu."""

import dataclasses
import glob
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# modules that must stay out: jax and the JAX package
FOREIGN = r"""
def foreign():
    return sorted(k for k in sys.modules
                  if k.split(".")[0] in ("jax", "jaxlib", "bark_tpu"))
"""

CODE = r"""
import importlib, pkgutil, sys
import bark_tpu_torch
names = ["bark_tpu_torch"]
for m in pkgutil.walk_packages(bark_tpu_torch.__path__, "bark_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
getattr(bark_tpu_torch, "bark_load_model")  # the lazily imported API
assert not foreign(), foreign()
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", FOREIGN + CODE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    # api, io, kernels, models, ops, pipeline, text and their modules
    assert int(out.stdout.strip()) >= 20


API_RUN = r"""
import json, sys
import numpy as np
import bark_tpu_torch as bt
params, paths = json.loads(sys.argv[1]), sys.argv[2:]
for path, packed in zip(paths, (False, True)):
    ctx = bt.bark_load_model(path, bt.BarkContextParams(
        **params, dequantize_on_load=not packed), seed=0, device="cpu")
    assert ("wte_q" in ctx.coarse_params) == packed
    assert bt.bark_generate_audio(ctx, "hello world")
    assert np.isfinite(bt.bark_get_audio_data(ctx)).all()
    if not packed:  # the batched path takes dense weights
        outs = ctx.generate_audio_batch(["hello world", "the a"])
        assert len(outs) == 2 and all(np.isfinite(o).all() and o.size
                                      for o in outs)
bt.bark_model_quantize(paths[0], paths[0] + ".q4", 2)
assert not foreign(), foreign()
print("ok")
"""


def test_cpu_api_imports_neither_jax_nor_bark_tpu(tmp_path):
    """The port's API end to end in a fresh interpreter, on model files
    this test writes first (tests/tiny_model.py imports bark_tpu, so it
    stays in this process)."""
    from bark_tpu.io import ggml, quantize
    from tiny_model import build_tiny_model, tiny_params

    dense, q8 = str(tmp_path / "w.bin"), str(tmp_path / "w8.bin")
    ggml.write_model_file(dense, build_tiny_model())
    quantize.model_quantize(dense, q8, int(ggml.GGMLFType.MOSTLY_Q8_0))
    params = {f.name: getattr(tiny_params(), f.name)
              for f in dataclasses.fields(tiny_params())
              if f.name not in ("progress_callback", "dequantize_on_load")}
    out = subprocess.run(
        [sys.executable, "-c", FOREIGN + API_RUN, json.dumps(params), dense,
         q8], cwd=tmp_path, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


PARALLEL = r"""
import sys
import bark_tpu_torch.parallel
from bark_tpu_torch.parallel import dryrun, launch, ranks, sharding, tp
assert not foreign(), foreign()
print("ok")
"""


def test_parallel_imports_neither_jax_nor_bark_tpu():
    """The multi-GPU package, which a spawned rank imports, in a fresh
    interpreter."""
    out = subprocess.run(
        [sys.executable, "-c", FOREIGN + PARALLEL], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_source_line_imports_bark_tpu():
    pattern = re.compile(r"^\s*(from|import)\s+bark_tpu(\.|\s|,|$)")
    files = glob.glob(os.path.join(ROOT, "bark_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 20
    bad = [f"{os.path.relpath(f, ROOT)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(open(f, encoding="utf-8"), 1)
           if pattern.match(line)]
    assert not bad, bad


def test_chip_smoke_imports_without_jax():
    """chip_smoke.py runs on the GPU machine: importing it pulls in no jax
    (its phases import the port lazily)."""
    code = FOREIGN + (
        "import sys; sys.path.insert(0, '.'); import chip_smoke; "
        "assert not foreign(), foreign()"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Without a CUDA device (this machine) the smoke run exits non-zero
    and prints no result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
