"""Plants a fault in the measured program for the benchmark's fault tests.

On PYTHONPATH, every process that imports the port's module named below
(the serve replica among them) gets it with the fault that
BENCH_H100_FAULT names:

- `token`: the engine alters every token where it is delivered: id + 1
  modulo the vocabulary;
- `half_batch`: `loss_fn` leaves out half of the batch and takes the mean
  over the rest;
- `frozen_step`: the optimizer's step returns the state unchanged.

Without the variable nothing is planted. Any sitecustomize that this one
shadows is run afterwards.
"""

import importlib.abc
import importlib.util
import importlib.machinery
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_FAULT = os.environ.get("BENCH_H100_FAULT", "")
_TARGET = {"token": "ray_tpu_torch.llm.engine",
           "half_batch": "ray_tpu_torch.models.transformer",
           "frozen_step": "ray_tpu_torch.models.transformer"}.get(_FAULT)


def _plant(module) -> None:
    if _FAULT == "token":
        deliver = module.ContinuousEngine._deliver

        def _deliver(self, slot, toks):
            return deliver(self, slot, [(t + 1) % self.cfg.vocab_size
                                        for t in toks])

        module.ContinuousEngine._deliver = _deliver
    elif _FAULT == "half_batch":
        loss_fn = module.loss_fn

        def half(model, tokens):
            return loss_fn(model, tokens[:max(1, tokens.shape[0] // 2)])

        module.loss_fn = half
    elif _FAULT == "frozen_step":
        import torch

        torch.optim.Adam.step = lambda self, closure=None: None


class _Finder(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name != _TARGET:
            return None
        spec = importlib.machinery.PathFinder.find_spec(name, path)
        if spec is None:
            return None
        run = spec.loader.exec_module

        def exec_module(module):
            run(module)
            _plant(module)

        spec.loader.exec_module = exec_module
        return spec


if _TARGET is not None:
    sys.meta_path.insert(0, _Finder())

_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _HERE])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
