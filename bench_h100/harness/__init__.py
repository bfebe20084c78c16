"""The H100 benchmark's harness: what every cell shares.

- `spec`: BENCHMARK.json and the files it names (configurations, traffic
  mixes, limits of the check, metric readers), found by name.
- `stats`: quantiles and the reduction of a window's records.
- `device`: the card's name, power limit, CUDA-event timing, the
  nvidia-smi sampler.
- `roofline`: published peaks, the flash kernels' operations and bytes,
  model FLOPs.
- `trace`: a torch.profiler Chrome trace reduced to device busy time,
  kernel times and idle gaps.
- `guards`: the modules a run may not load, the shared-memory files it may
  not leave, the cache directories it uses.
"""
