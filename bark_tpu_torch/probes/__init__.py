"""Probes of the card, the port's counterparts of the JAX package's
`tools/tpu_*` probes:

- dma: D1-D5, the weight stream from device memory to the SMs
  (`tools/tpu_dma_probe.py`), one hand-written kernel over four load
  methods; `python -m bark_tpu_torch.probes.dma` sweeps it.
- cache: C1-C3, the cold start (`tools/tpu_cache_probe.py`,
  `tests/test_cache.py`): the kernel build cache of `kernels/_build.py`,
  the library load and first launches; `python -m
  bark_tpu_torch.probes.cache` runs it, twice for a second process.
- lowering: P1-P9, what the constructs of a whole-stage decode kernel cost
  (`tools/tpu_mosaic_probe.py`): a loop on a device flag, an argmax that
  indexes a load, row loads at a loop's index, shared memory at a run-time
  layer index, a weight ring across layers, stores at run-time offsets, a
  dot over a multi-slot operand; `python -m bark_tpu_torch.probes.lowering`
  runs the reference's ten, `--sweep` the questions at bark-small sizes.
"""
