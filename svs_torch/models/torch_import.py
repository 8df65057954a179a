"""Reference ``.pth`` checkpoints and weights from svs_tpu (port of
``svs_tpu/models/torch_import.py``).

The port's :class:`~svs_torch.models.unet.UNet` already carries the
reference's state-dict keys and layouts, so a reference ``.pth`` loads
directly.  What remains here:

- :func:`load_pth` / :func:`save_pth` for both reference on-disk formats
  (bare ``model.save`` dicts, model.py:140-152, and train.py's rich dicts,
  train.py:369-382);
- the port's own numpy copies of svs_tpu's layout conversions
  (torch_import.py:34-47), and :func:`state_dict_from_jax`, which turns
  svs_tpu's functional pytrees (as numpy arrays) into the port's state dict
  — the way weights cross between the two packages in every test.

Layouts:
- torch Conv2d weight (O, I, kh, kw)          <-> HWIO (kh, kw, I, O)
- torch ConvTranspose2d weight (I, O, kh, kw) <-> pre-flipped conv-equivalent
  HWIO kernel K[h, w, i, o] = W[i, o, kh-1-h, kw-1-w] (svs_tpu's lhs-dilated
  deconv form).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch


def conv_weight_to_hwio(w_oihw: np.ndarray) -> np.ndarray:
    return np.transpose(w_oihw, (2, 3, 1, 0))


def conv_weight_from_hwio(w_hwio: np.ndarray) -> np.ndarray:
    return np.transpose(w_hwio, (3, 2, 0, 1))


def deconv_weight_to_hwio(w_iohw: np.ndarray) -> np.ndarray:
    return np.transpose(w_iohw, (2, 3, 0, 1))[::-1, ::-1, :, :].copy()


def deconv_weight_from_hwio(w_hwio: np.ndarray) -> np.ndarray:
    return np.transpose(w_hwio[::-1, ::-1, :, :], (2, 3, 0, 1)).copy()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def state_dict_from_jax(params: Mapping[str, Any],
                        bn_state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """svs_tpu ``(params, bn_state)`` pytrees (leaves as numpy arrays) ->
    the port's (reference-keyed) state dict."""
    sd: Dict[str, torch.Tensor] = {}
    nbt = torch.tensor(0, dtype=torch.long)
    for i, (p, s) in enumerate(zip(params["enc"], bn_state["enc"]), start=1):
        sd[f"conv{i}.0.weight"] = _t(conv_weight_from_hwio(np.asarray(p["w"])))
        sd[f"conv{i}.0.bias"] = _t(p["b"])
        sd[f"conv{i}.1.weight"] = _t(p["scale"])
        sd[f"conv{i}.1.bias"] = _t(p["bias"])
        sd[f"conv{i}.1.running_mean"] = _t(s["mean"])
        sd[f"conv{i}.1.running_var"] = _t(s["var"])
        sd[f"conv{i}.1.num_batches_tracked"] = nbt.clone()
    for i, p in enumerate(params["dec"], start=1):
        sd[f"deconv{i}.weight"] = _t(
            deconv_weight_from_hwio(np.asarray(p["w"])))
        sd[f"deconv{i}.bias"] = _t(p["b"])
        if i < 6:
            s = bn_state["dec"][i - 1]
            sd[f"deconv{i}_BAD.0.weight"] = _t(p["scale"])
            sd[f"deconv{i}_BAD.0.bias"] = _t(p["bias"])
            sd[f"deconv{i}_BAD.0.running_mean"] = _t(s["mean"])
            sd[f"deconv{i}_BAD.0.running_var"] = _t(s["var"])
            sd[f"deconv{i}_BAD.0.num_batches_tracked"] = nbt.clone()
    return sd


def jax_path(name: str) -> Optional[Tuple[str, str, int, str]]:
    """Where a state-dict entry lives in svs_tpu's pytrees: ``(tree, side,
    level, field)``, tree ``"params"`` or ``"bn_state"``, side ``"enc"`` or
    ``"dec"``, the level counted from 0; ``None`` for what svs_tpu does not
    keep (``num_batches_tracked``)."""
    m = re.fullmatch(r"conv(\d+)\.([01])\.(weight|bias|running_mean|"
                     r"running_var)", name)
    if m:
        i, mod, kind = int(m[1]) - 1, m[2], m[3]
        if mod == "0":
            return "params", "enc", i, {"weight": "w", "bias": "b"}[kind]
        if kind.startswith("running"):
            return "bn_state", "enc", i, kind[len("running_"):]
        return "params", "enc", i, {"weight": "scale", "bias": "bias"}[kind]
    m = re.fullmatch(r"deconv(\d+)\.(weight|bias)", name)
    if m:
        return "params", "dec", int(m[1]) - 1, {"weight": "w",
                                                 "bias": "b"}[m[2]]
    m = re.fullmatch(r"deconv(\d+)_BAD\.0\.(weight|bias|running_mean|"
                     r"running_var)", name)
    if m:
        i, kind = int(m[1]) - 1, m[2]
        if kind.startswith("running"):
            return "bn_state", "dec", i, kind[len("running_"):]
        return "params", "dec", i, {"weight": "scale", "bias": "bias"}[kind]
    if name.endswith("num_batches_tracked"):
        return None
    raise KeyError(f"no svs_tpu counterpart for state-dict entry {name!r}")


def to_jax_layout(name: str, a: np.ndarray) -> np.ndarray:
    """A state-dict entry (or anything shaped like it: Adam's moments, an
    accumulated gradient) in svs_tpu's layout: convs HWIO, deconvs the
    pre-flipped conv-equivalent HWIO kernel."""
    if name.endswith("weight") and a.ndim == 4:
        return (deconv_weight_to_hwio(a) if name.startswith("deconv")
                else conv_weight_to_hwio(a))
    return a


def from_jax_layout(name: str, a: np.ndarray) -> np.ndarray:
    """Inverse of :func:`to_jax_layout`."""
    if name.endswith("weight") and a.ndim == 4:
        return (deconv_weight_from_hwio(a) if name.startswith("deconv")
                else conv_weight_from_hwio(a))
    return a


def load_pth(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Read a reference ``.pth`` checkpoint on the CPU.

    Returns ``(state_dict, extras)``; extras carries epoch / loss histories
    when present.  Only plain tensors and containers are unpickled
    (``weights_only=True``): the reference formats need nothing else.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = dict(sd)
    extras = {}
    if isinstance(ckpt, dict):
        for key in ckpt:
            if key.startswith("loss_list") or key == "epoch":
                extras[key] = ckpt[key]
    return sd, extras


def save_pth(path: str,
             model: Union[torch.nn.Module, Mapping[str, torch.Tensor]], *,
             epoch: int = 0) -> None:
    """Write a reference-loadable checkpoint (train.py rich-dict format,
    reference train.py:369-382, minus optimizer internals) of a model or
    of its state dict."""
    if isinstance(model, torch.nn.Module):
        model = model.state_dict()
    sd = {k: v.detach().cpu() for k, v in model.items()}
    torch.save({"model_state_dict": sd, "epoch": int(epoch),
                "scheduler": None}, path)
