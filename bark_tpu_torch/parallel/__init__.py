"""Multi-GPU serving (the counterpart of `bark_tpu.parallel`):
`sharding` (the (dp, tp) mesh over torch.distributed, the specs, the
placement, `shard_context_dp` and `shard_context`, the step factories),
`tp` (the tensor-parallel forward), `launch` (`spawn`, one process a rank
with no network) and `dryrun` (`python -m bark_tpu_torch.parallel.dryrun
N`)."""
