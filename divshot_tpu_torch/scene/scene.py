"""Scene and Entity containers with JSON (+ NPZ) serialization
(counterpart of ``divshot_tpu/scene/scene.py``). Entities hold a name, a
4x4 transform, an active flag, an optional parent and typed components.
The files are JAX's: each package reads the other's.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from divshot_tpu_torch.scene import components as C

SCENE_VERSION = 1


@dataclass
class Entity:
    name: str
    transform: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    active: bool = True
    parent: str | None = None
    components: dict = field(default_factory=dict)

    def add(self, comp: Any) -> Any:
        self.components[type(comp).__name__] = comp
        return comp

    def get(self, comp_type) -> Any | None:
        return self.components.get(comp_type.__name__)

    def world_transform(self, scene: "Scene") -> np.ndarray:
        m = self.transform
        if self.parent:
            parent = scene.find(self.parent)
            if parent is not None:
                m = parent.world_transform(scene) @ m
        return m


class Scene:
    def __init__(self, name: str = "scene"):
        self.name = name
        self.entities: list[Entity] = []

    def create_entity(self, name: str, **kw) -> Entity:
        e = Entity(name=name, **kw)
        self.entities.append(e)
        return e

    def remove(self, name: str) -> bool:
        before = len(self.entities)
        self.entities = [e for e in self.entities if e.name != name]
        return len(self.entities) != before

    def find(self, name: str) -> Entity | None:
        for e in self.entities:
            if e.name == name:
                return e
        return None

    def entities_with(self, comp_type) -> list[Entity]:
        return [e for e in self.entities
                if comp_type.__name__ in e.components]

    # ---- serialization ----

    def save(self, path: str) -> None:
        """Writes ``path`` (JSON) and ``path.npz`` with the inline splat
        params of components that have no backing file."""
        arrays: dict[str, np.ndarray] = {}
        doc = {"version": SCENE_VERSION, "name": self.name, "entities": []}
        for e in self.entities:
            ent = {
                "name": e.name,
                "transform": np.asarray(e.transform).tolist(),
                "active": e.active,
                "parent": e.parent,
                "components": [],
            }
            for comp in e.components.values():
                d = C.component_to_dict(comp)
                if isinstance(comp, C.GaussianComponent) and \
                        comp.params is not None and not comp.path:
                    key = f"{e.name}/params"
                    for k, v in comp.params.compact_numpy().items():
                        arrays[f"{key}/{k}"] = v
                    d["__params_key__"] = key
                ent["components"].append(d)
            doc["entities"].append(ent)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        if arrays:
            np.savez_compressed(path + ".npz", **arrays)

    @classmethod
    def load(cls, path: str, *, device="cuda") -> "Scene":
        """Read a scene; inline splat params go to ``device``."""
        with open(path) as f:
            doc = json.load(f)
        npz = None
        if os.path.exists(path + ".npz"):
            npz = np.load(path + ".npz")
        scene = cls(doc.get("name", "scene"))
        for ent in doc["entities"]:
            e = scene.create_entity(
                ent["name"],
                transform=np.asarray(ent["transform"], np.float32),
                active=ent.get("active", True),
                parent=ent.get("parent"))
            for d in ent.get("components", []):
                comp = _component_from_dict(d, npz, device)
                if comp is not None:
                    e.add(comp)
        return scene


def _crop_volume(v: dict) -> C.CropVolume:
    v = dict(v)
    v.pop("__type__", None)
    return C.CropVolume(**{
        **v, "type": C.CropType(v["type"]), "center": tuple(v["center"]),
        "pmin": tuple(v["pmin"]), "pmax": tuple(v["pmax"])})


def _component_from_dict(d: dict, npz, device) -> Any | None:
    ty = d.get("__type__")
    d = {k: v for k, v in d.items()
         if not k.startswith("__") or k == "__params_key__"}
    key = d.pop("__params_key__", None)
    if ty == "GaussianComponent":
        crop = d.pop("crop", None)
        comp = C.GaussianComponent(**{
            **d, "render_type": C.GaussianRenderType(d["render_type"]),
            "albedo_color": tuple(d["albedo_color"])})
        if crop:
            gc = C.GaussianCrop()
            for v in crop.get("volumes", []):
                gc.add(_crop_volume(v))
            comp.crop = gc
        if key is not None and npz is not None:
            from divshot_tpu_torch.splat.gaussians import GaussianParams
            g = {k.split("/")[-1]: npz[k] for k in npz.files
                 if k.startswith(key + "/")}
            means = g.pop("means")
            degree = {0: 0, 3: 1, 8: 2, 15: 3}[g["shN"].shape[1]]
            comp.params = GaussianParams.create(means, sh_degree=degree,
                                                device=device, **g)
        return comp
    if ty == "Environment":
        return C.Environment(**{
            **d, "mode": C.EnvironmentMode(d["mode"]),
            "sky_ambient": tuple(d["sky_ambient"]),
            "sun_color": tuple(d["sun_color"])})
    if ty == "Light":
        return C.Light(**{
            **d, "type": C.LightType(d["type"]),
            "position": tuple(d["position"]),
            "direction": tuple(d["direction"]),
            "color": tuple(d["color"]), "size": tuple(d["size"])})
    if ty == "GaussianCrop":
        gc = C.GaussianCrop()
        for v in d.get("volumes", []):
            v = dict(v)
            v.pop("__type__", None)
            gc.add(C.CropVolume(**{**v, "type": C.CropType(v["type"])}))
        return gc
    return None
