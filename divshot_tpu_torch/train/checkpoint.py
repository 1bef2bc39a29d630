"""Checkpoint and resume (counterpart of
``divshot_tpu/train/checkpoint.py``).

``iteration_N/`` under the model path holds ``state.pt`` and a
``point_cloud.ply`` of the params beside it, as in JAX. ``state.pt`` is
one ``torch.save`` of plain tensors, ints and strings, read back with
``weights_only=True``: the params, the Adam moments and step, the
densification statistics, the strategies' ``torch.Generator`` state, with
``enable_bg`` the envmap and its Adam moments (JAX's checkpoint keeps no
envmap) and, when given, the trainer's view sampler (a numpy
``Generator``, whose ``bit_generator.state`` is a dict of ints), its
instance capacity and a streamed run's views drawn ahead of the step. So
a resumed run takes the same views and draws as an unbroken one (JAX's
view sampler restarts from the seed). Every tensor keeps the dtype it is
stored in: ``pack_level``'s bf16 ``shN`` and moments stay bf16.

The dynamic models' checkpoints (``save_dynamic``, ``load_dynamic``) add
the deformation network's parameters and its Adam moments and count to
the same file (JAX: the whole ``DynTrainState`` pytree through orbax).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from divshot_tpu_torch.gsio import ply as P
from divshot_tpu_torch.train import strategy as S
from divshot_tpu_torch.train.optim import PARAM_FIELDS, AdamState
from divshot_tpu_torch.train.trainer import TrainState

_PARAM_TENSORS = PARAM_FIELDS + ("alive",)
_DSTATE = tuple(f.name for f in dataclasses.fields(S.DensifyState))


def checkpoint_dir(model_path: str, step: int) -> str:
    return os.path.join(os.path.abspath(model_path), f"iteration_{step}")


def state_dict(state: TrainState, sampler: np.random.Generator | None = None,
               instance_capacity: int | None = None,
               pending_views: list[int] | None = None) -> dict:
    """The train state as plain tensors (on the host), ints and strings."""
    def host(t):
        return t.detach().cpu().clone()

    out = {
        "params": {f: host(getattr(state.params, f))
                   for f in _PARAM_TENSORS},
        "mu": {f: host(t) for f, t in state.opt.mu.items()},
        "nu": {f: host(t) for f, t in state.opt.nu.items()},
        "step": int(state.opt.step),
        "dstate": {f: host(getattr(state.dstate, f)) for f in _DSTATE},
        "gen": state.gen.get_state(),
    }
    if getattr(state, "bg", None) is not None:
        out["bg"] = {k: host(t) for k, t in state.bg.items()}
    if pending_views:
        out["pending_views"] = [int(v) for v in pending_views]
    if sampler is not None:
        out["sampler"] = sampler.bit_generator.state
    if instance_capacity is not None:
        out["instance_capacity"] = int(instance_capacity)
    return out


def save_checkpoint(model_path: str, state: TrainState, *, step: int,
                    export_ply: bool = True,
                    sampler: np.random.Generator | None = None,
                    instance_capacity: int | None = None,
                    pending_views: list[int] | None = None) -> str:
    """Write ``iteration_{step}/state.pt`` (and its ``point_cloud.ply``)
    -> the directory."""
    path = checkpoint_dir(model_path, step)
    os.makedirs(path, exist_ok=True)
    torch.save(state_dict(state, sampler, instance_capacity, pending_views),
               os.path.join(path, "state.pt"))
    if export_ply:
        P.save_ply(os.path.join(path, "point_cloud.ply"), state.params)
    return path


def latest_step(model_path: str) -> int | None:
    if not os.path.isdir(model_path):
        return None
    steps = [int(d[10:]) for d in os.listdir(model_path)
             if d.startswith("iteration_") and d[10:].isdigit()]
    return max(steps) if steps else None


def load_state_dict(model_path: str, step: int) -> dict:
    """``iteration_{step}/state.pt`` as saved, its tensors on the host."""
    return torch.load(os.path.join(checkpoint_dir(model_path, step),
                                   "state.pt"),
                      map_location="cpu", weights_only=True)


def load_checkpoint(model_path: str, step: int, template: TrainState,
                    sampler: np.random.Generator | None = None
                    ) -> TrainState:
    """-> the saved state on ``template``'s device (its generator a new
    one in the saved state). A ``sampler`` given is set to the saved view
    sampler's state."""
    return _from_state_dict(load_state_dict(model_path, step), template,
                            sampler)


def _from_state_dict(d: dict, template: TrainState,
                     sampler: np.random.Generator | None) -> TrainState:
    dev = template.params.device

    def dev_(t):
        return t.to(dev)

    params = dataclasses.replace(
        template.params, **{f: dev_(d["params"][f]) for f in _PARAM_TENSORS})
    opt = AdamState(mu={f: dev_(t) for f, t in d["mu"].items()},
                    nu={f: dev_(t) for f, t in d["nu"].items()},
                    step=int(d["step"]))
    dstate = S.DensifyState(**{f: dev_(d["dstate"][f]) for f in _DSTATE})
    gen = torch.Generator(device=dev)
    gen.set_state(d["gen"])
    if sampler is not None and "sampler" in d:
        sampler.bit_generator.state = d["sampler"]
    bg = None
    if "bg" in d:
        bg = {k: dev_(t) for k, t in d["bg"].items()}
    return TrainState(params=params, opt=opt, dstate=dstate, gen=gen, bg=bg)


def save_trainer(model_path: str, trainer, *, step: int,
                 export_ply: bool = True) -> str:
    """``save_checkpoint`` of a ``Trainer``'s state with its view sampler,
    instance capacity and views drawn ahead."""
    return save_checkpoint(model_path, trainer.state, step=step,
                           export_ply=export_ply, sampler=trainer._np_rng,
                           instance_capacity=trainer.instance_capacity,
                           pending_views=trainer.pending_views)


def resume_trainer(model_path: str, trainer, step: int) -> None:
    """Load ``iteration_{step}`` into a ``Trainer``: its state, its view
    sampler and, where saved, its instance capacity and the views a
    streamed run had drawn ahead."""
    d = load_state_dict(model_path, step)
    trainer.state = _from_state_dict(d, trainer.state, trainer._np_rng)
    if trainer.dataset.streamed:
        trainer.set_pending_views(d.get("pending_views", []))
    icap = d.get("instance_capacity")
    if icap is not None and icap != trainer.instance_capacity:
        trainer._render_kwargs["instance_capacity"] = icap
        trainer._build_steps()


# ---------------------------------------------------------------------------
# the dynamic models' state (``models/dynamic.DynTrainState``)


def dynamic_state_dict(state, sampler: np.random.Generator | None = None,
                       instance_capacity: int | None = None) -> dict:
    """A ``DynTrainState`` as plain tensors on the host, ints and
    strings: ``state_dict``'s entries, the network's ``state_dict`` and
    its Adam moments and count."""
    out = state_dict(state, sampler, instance_capacity)
    out["net"] = {k: t.detach().cpu().clone()
                  for k, t in state.net.state_dict().items()}
    out["net_opt"] = {
        "mu": {k: t.detach().cpu().clone() for k, t in
               state.net_opt.mu.items()},
        "nu": {k: t.detach().cpu().clone() for k, t in
               state.net_opt.nu.items()},
        "count": int(state.net_opt.count)}
    return out


def save_dynamic(model_path: str, trainer, *, step: int) -> str:
    """``iteration_{step}/state.pt`` of a ``DynamicTrainer``: its whole
    state, view sampler and instance capacity -> the directory."""
    path = checkpoint_dir(model_path, step)
    os.makedirs(path, exist_ok=True)
    torch.save(dynamic_state_dict(trainer.state, trainer._np_rng,
                                  trainer.instance_capacity),
               os.path.join(path, "state.pt"))
    return path


def load_dynamic(model_path: str, step: int, template,
                 sampler: np.random.Generator | None = None):
    """-> the saved ``DynTrainState`` on ``template``'s device, its
    network ``template.net`` with the saved parameters loaded in place. A
    ``sampler`` given is set to the saved view sampler's state."""
    from divshot_tpu_torch.models.dynamic import DynTrainState, NetAdamState
    d = load_state_dict(model_path, step)
    st = _from_state_dict(d, template, sampler)
    dev = template.params.device
    template.net.load_state_dict(d["net"])
    net_opt = NetAdamState(
        mu={k: t.to(dev) for k, t in d["net_opt"]["mu"].items()},
        nu={k: t.to(dev) for k, t in d["net_opt"]["nu"].items()},
        count=int(d["net_opt"]["count"]))
    return DynTrainState(params=st.params, opt=st.opt, dstate=st.dstate,
                         net=template.net, net_opt=net_opt, gen=st.gen)
