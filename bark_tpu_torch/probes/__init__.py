"""Probes of the card, the port's counterparts of the JAX package's
`tools/tpu_*` probes:

- dma: D1-D5, the weight stream from device memory to the SMs
  (`tools/tpu_dma_probe.py`), one hand-written kernel over four load
  methods; `python -m bark_tpu_torch.probes.dma` sweeps it.
"""
