"""The system under test, ``repro_torch``, as the benchmark reaches it:
the model of a configuration file, its train step and its serving steps,
the kernels' build, and the entry points the probes time. The only
module of the benchmark that imports the program."""
from __future__ import annotations

import importlib
import time
from typing import Dict

import torch


def model_config(model: dict):
    """The port's ``ModelConfig`` of a configuration file's ``model``."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    kw = dict(model)
    if "ssm" in kw:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    return ModelConfig(**kw)


def build_model(model: dict, device):
    """The port's model of ``model`` on ``device``, with no parameters of
    its own: every call is handed the benchmark's."""
    from repro_torch.models import build_model as build
    return build(model_config(model), device=device)


def build_kernels() -> float:
    """Build (the first run in a checkout) or load the port's CUDA
    libraries from ``build/kernels``; returns the seconds it took."""
    from repro_torch.kernels import _build
    t = time.perf_counter()
    _build.build_all()
    return time.perf_counter() - t


def train_state(params: Dict[str, torch.Tensor]):
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import TrainState
    return TrainState(params=params, opt=adamw_init(params))


def train_step(model, opt: dict):
    from repro_torch.train import OptConfig, make_train_step
    return make_train_step(model, OptConfig(**opt))


def prefill_step(model, max_len: int):
    from repro_torch.serve.serve_step import make_prefill_step
    return make_prefill_step(model, max_len=max_len)


def decode_step(model):
    from repro_torch.serve.serve_step import make_decode_step
    return make_decode_step(model)


def train_targets(model) -> Dict[str, tuple]:
    """What a traced training run times, by name: the forward
    (``Model.loss``), the optimizer (``adamw_update`` as the train step
    calls it), K5's entry (``ops.flash_attention_vjp``; with remat every
    layer's forward runs twice) and K6's (``flash_attention_bwd_cuda`` as
    the autograd function calls it)."""
    # by module path: ``repro_torch.kernels`` re-exports functions of the
    # same names as these modules
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    ops = importlib.import_module("repro_torch.kernels.ops")
    ts = importlib.import_module("repro_torch.train.train_step")
    return {"loss": (model, "loss"), "adamw": (ts, "adamw_update"),
            "k5": (ops, "flash_attention_vjp"),
            "k6": (fa, "flash_attention_bwd_cuda")}


def serve_targets(model) -> Dict[str, tuple]:
    """What a traced serving run times: K5's entry, reached from the
    prefill only."""
    ops = importlib.import_module("repro_torch.kernels.ops")
    return {"k5": (ops, "flash_attention_vjp")}


def first_moments(state) -> Dict[str, torch.Tensor]:
    """AdamW's first moment of every parameter, as the state holds it."""
    return state.opt["m"]
