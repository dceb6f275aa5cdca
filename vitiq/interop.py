"""Reference (PyTorch) checkpoint interop.

Imports a trained reference-model `state_dict` into a vitiq parameter tree so
existing experiments port without retraining. Key layout follows the
reference module trees exactly:

  ViT arm (ref: ViT/models/encoder.py, amc_transformer.py):
    encoder.patch_embedding.projection.{weight,bias}   Conv2d [d, C, p, p]
    encoder.cls_token                                  [1, 1, d]
    encoder.layers.{i}.attention.w_{q,k,v,concat}.{weight,bias}
    encoder.layers.{i}.norm{1,2}.{gamma,beta}
    encoder.layers.{i}.ffn.linear{1,2}.{weight,bias}
    mlp_head.{weight,bias}

  rawIQ arm (ref: transformer_rawIQ/models/encoder.py, transformer_rawIQ.py):
    encoder.sequence_embedding.projection.{weight,bias}  Conv1d [d, 2, k]
      (the rawIQ Encoder registers `self.sequence_embedding`,
       ref: transformer_rawIQ/models/encoder.py:37,50)
    encoder.cls_token (optional)
    encoder.layers... (same as above)
    mlp_head.0.{weight,bias} (the head is a torch nn.LayerNorm — it registers
      weight/bias, NOT gamma/beta), mlp_head.1.{weight,bias}
      (ref: transformer_rawIQ/models/transformer_rawIQ.py:67-70)

Layout conversions (the transposes/flattens vitiq's fold+GEMM layers expect,
verified against torch conv semantics in tests/test_layers.py):
  Linear  [out, in]      -> kernel [in, out]
  Conv2d  [d, C, p, p]   -> kernel [(C*p*p), d] with (C, kh, kw) row order
  Conv1d  [d, C, k]      -> kernel [(C*k), d]  with (C, k) row order
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import jax.numpy as jnp
import numpy as np

from vitiq.config import ModelConfig


def _np(t) -> np.ndarray:
    """torch tensor / ndarray -> ndarray (torch import stays optional)."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _linear(sd: Mapping, prefix: str) -> Dict[str, jnp.ndarray]:
    w = _np(sd[f"{prefix}.weight"])  # [out, in]
    b = _np(sd[f"{prefix}.bias"])
    return {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)}


def _norm(sd: Mapping, prefix: str) -> Dict[str, jnp.ndarray]:
    return {"gamma": jnp.asarray(_np(sd[f"{prefix}.gamma"])),
            "beta": jnp.asarray(_np(sd[f"{prefix}.beta"]))}


def _conv_proj(sd: Mapping, prefix: str) -> Dict[str, jnp.ndarray]:
    w = _np(sd[f"{prefix}.weight"])  # [d, C, ...k]
    d = w.shape[0]
    return {"kernel": jnp.asarray(w.reshape(d, -1).T),
            "bias": jnp.asarray(_np(sd[f"{prefix}.bias"]))}


def load_torch_state_dict(state_dict: Mapping[str, Any], cfg: ModelConfig):
    """Reference state_dict -> vitiq parameter tree for `cfg`.

    Raises KeyError with the missing reference key on any mismatch, so an
    arm/config mix-up fails loudly.
    """
    cfg.validate()
    sd = state_dict

    layers = []
    for i in range(cfg.n_layers):
        p = f"encoder.layers.{i}"
        layers.append({
            "attention": {
                "w_q": _linear(sd, f"{p}.attention.w_q"),
                "w_k": _linear(sd, f"{p}.attention.w_k"),
                "w_v": _linear(sd, f"{p}.attention.w_v"),
                "w_concat": _linear(sd, f"{p}.attention.w_concat"),
            },
            "norm1": _norm(sd, f"{p}.norm1"),
            "ffn": {
                "linear1": _linear(sd, f"{p}.ffn.linear1"),
                "linear2": _linear(sd, f"{p}.ffn.linear2"),
            },
            "norm2": _norm(sd, f"{p}.norm2"),
        })

    if cfg.arm == "vit":
        encoder = {
            "embedding": {"proj": _conv_proj(sd, "encoder.patch_embedding.projection")},
            "cls_token": jnp.asarray(_np(sd["encoder.cls_token"])),
            "layers": layers,
        }
        return {"encoder": encoder, "mlp_head": _linear(sd, "mlp_head")}

    encoder = {
        "embedding": {"proj": _conv_proj(sd, "encoder.sequence_embedding.projection")},
        "layers": layers,
    }
    if cfg.use_cls_token:
        encoder["cls_token"] = jnp.asarray(_np(sd["encoder.cls_token"]))
    # rawIQ head = Sequential(nn.LayerNorm, Linear) -> keys mlp_head.0 / .1;
    # torch LayerNorm's affine params are named weight/bias
    # (ref: transformer_rawIQ/models/transformer_rawIQ.py:67-70)
    head_norm = {"gamma": jnp.asarray(_np(sd["mlp_head.0.weight"])),
                 "beta": jnp.asarray(_np(sd["mlp_head.0.bias"]))}
    return {"encoder": encoder, "head_norm": head_norm,
            "mlp_head": _linear(sd, "mlp_head.1")}


def load_torch_checkpoint(path: str, cfg: ModelConfig):
    """Load a reference .pth training checkpoint (expects the reference's
    checkpoint dict with 'model_state_dict', ref: ViT/training/utils.py:550-587,
    or a bare state_dict)."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("model_state_dict", blob) if isinstance(blob, dict) else blob
    return load_torch_state_dict(sd, cfg)
