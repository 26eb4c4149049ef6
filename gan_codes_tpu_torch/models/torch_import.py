"""Reference-format weights for the port (the port of the serving and
export halves of `gan_codes_tpu/models/torch_import.py`).

The port's modules carry the reference's state_dict names, so a reference
`gen_N.pth` (or the `generator` entry of a `checkpoint.pt`) and
`text_encoder.pth` load directly. This module infers the architecture from
a state_dict, loads the files into modules, and carries JAX parameter trees
across to reference-keyed state_dicts:

  * Linear weight: JAX [in, out] -> torch [out, in] (transpose)
  * Conv2d weight: JAX HWIO -> torch OIHW
  * block `gamma`: JAX scalar () -> torch shape [1]
  * LSTM: JAX [in, 4H] per direction -> torch [4H, in], gate order
    (i, f, g, o) unchanged
  * InceptionV3 (`inception_params_from_jax`): each folded conv's HWIO
    `w` -> OIHW, `fc.w` [2048, 1000] -> [1000, 2048]

The JAX trees arrive as nested dicts/lists of numpy arrays (for example
`jax.device_get(params)`); nothing here imports JAX.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import GeneratorConfig, TextEncoderConfig
from .generator import Generator
from .text_encoder import RNNEncoder

StateDict = Dict[str, torch.Tensor]


def torch_load_ref(path: str) -> Any:
    """torch.load for reference artifacts, weights-only.

    Reference checkpoint.pt files hold numpy scalars in their loss
    histories, which the weights-only unpickler rejects; retry with only
    the numpy scalar/dtype globals allowed (still weights-only)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        core = getattr(np, "_core", None) or np.core
        allow = [core.multiarray.scalar, np.dtype]
        allow += [getattr(np.dtypes, n) for n in dir(np.dtypes)
                  if n.endswith("DType")]
        with torch.serialization.safe_globals(allow):
            return torch.load(path, map_location="cpu", weights_only=True)


def _maybe_unwrap(obj: Any, key: str) -> StateDict:
    """A raw state_dict, or the `key` entry of a full checkpoint.pt dict."""
    if key in obj and isinstance(obj[key], dict):
        return obj[key]
    return obj


def infer_generator_config(sd: StateDict) -> GeneratorConfig:
    """The architecture a generator state_dict was trained as: shapes pin
    n_channels, latent and sentence dims, the MLP width, and the number of
    `res_blocks.N` prefixes gives the depth (image_size = 4 << n_up)."""
    out_dim, latent_dim = sd["linear_in.weight"].shape
    n_channels = out_dim // (8 * 4 * 4)
    n_up = len({k.split(".")[1] for k in sd if k.startswith("res_blocks.")})
    hidden, sentence_dim = sd[
        "res_blocks.0.fusion_block_1.gamma_mlp.0.weight"].shape
    return GeneratorConfig(n_channels=int(n_channels),
                           latent_dim=int(latent_dim),
                           sentence_dim=int(sentence_dim),
                           affine_hidden=int(hidden),
                           image_size=4 << n_up)


def infer_text_encoder_config(sd: StateDict, max_len: int = 18
                              ) -> TextEncoderConfig:
    """Vocabulary, embedding and hidden widths from a text-encoder
    state_dict's shapes."""
    vocab, embed = sd["encoder.weight"].shape
    per_dir = sd["rnn.weight_hh_l0"].shape[1]
    bidirectional = "rnn.weight_hh_l0_reverse" in sd
    return TextEncoderConfig(vocab_size=int(vocab), embed_dim=int(embed),
                             hidden_dim=int(per_dir) * (2 if bidirectional
                                                        else 1),
                             max_len=max_len, bidirectional=bidirectional)


def load_generator(path: str, cfg: Optional[GeneratorConfig] = None
                   ) -> Tuple[Generator, GeneratorConfig]:
    """A reference `gen_N.pth` (or `checkpoint.pt`) -> (Generator on the
    CPU, its config). With cfg=None the architecture is inferred."""
    sd = _maybe_unwrap(torch_load_ref(path), "generator")
    if cfg is None:
        cfg = infer_generator_config(sd)
    g = Generator(cfg)
    g.load_state_dict(sd, strict=True)
    return g.eval(), cfg


def load_text_encoder(path: str, cfg: Optional[TextEncoderConfig] = None
                      ) -> Tuple[RNNEncoder, TextEncoderConfig]:
    """A reference `text_encoder.pth` -> (RNNEncoder on the CPU, its
    config). With cfg=None the widths are inferred from the shapes."""
    sd = torch_load_ref(path)
    if cfg is None:
        cfg = infer_text_encoder_config(sd)
    te = RNNEncoder(cfg)
    te.load_state_dict(sd, strict=True)
    return te.eval(), cfg


# -- the carry-across from JAX parameter trees (numpy leaves) -------------

def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _lin(sd: StateDict, prefix: str, p: Dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["w"]).t().contiguous()
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def _conv(sd: StateDict, prefix: str, p: Dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["w"]).permute(3, 2, 0, 1).contiguous()
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def _affine(sd: StateDict, prefix: str, p: Dict) -> None:
    for mlp in ("gamma_mlp", "beta_mlp"):
        _lin(sd, f"{prefix}.{mlp}.0", p[mlp][0])
        _lin(sd, f"{prefix}.{mlp}.2", p[mlp][1])


def generator_state_dict_from_jax(params: Dict) -> StateDict:
    """The JAX package's generator tree -> a reference-keyed state_dict
    (the same mapping as the JAX package's `export_generator_state_dict`).
    The last entry of `params["blocks"]` is `res_block_out`."""
    sd: StateDict = {}
    _lin(sd, "linear_in", params["linear_in"])
    names = [f"res_blocks.{i}"
             for i in range(len(params["blocks"]) - 1)] + ["res_block_out"]
    for name, bp in zip(names, params["blocks"]):
        _affine(sd, f"{name}.fusion_block_1", bp["affine_1"])
        _affine(sd, f"{name}.fusion_block_2", bp["affine_2"])
        _conv(sd, f"{name}.conv_1", bp["conv_1"])
        _affine(sd, f"{name}.fusion_block_3", bp["affine_3"])
        _affine(sd, f"{name}.fusion_block_4", bp["affine_4"])
        _conv(sd, f"{name}.conv_2", bp["conv_2"])
        if "shortcut_conv" in bp:
            _conv(sd, f"{name}.scale_conv", bp["shortcut_conv"])
        sd[f"{name}.gamma"] = _t(bp["gamma"]).reshape(1)
    _conv(sd, "conv_out.1", params["conv_out"])
    return sd


def text_encoder_state_dict_from_jax(params: Dict) -> StateDict:
    """The JAX package's text-encoder tree (`embedding`, `fwd`, optional
    `bwd`, each direction `w_ih [E, 4H]`, `w_hh [H, 4H]`, `b_ih`, `b_hh`)
    -> a reference-keyed state_dict (the inverse of the JAX package's
    `convert_torch_state_dict`)."""
    sd: StateDict = {"encoder.weight": _t(params["embedding"])}
    for key, suffix in (("fwd", ""), ("bwd", "_reverse")):
        if key not in params:
            continue
        d = params[key]
        sd[f"rnn.weight_ih_l0{suffix}"] = _t(d["w_ih"]).t().contiguous()
        sd[f"rnn.weight_hh_l0{suffix}"] = _t(d["w_hh"]).t().contiguous()
        sd[f"rnn.bias_ih_l0{suffix}"] = _t(d["b_ih"])
        sd[f"rnn.bias_hh_l0{suffix}"] = _t(d["b_hh"])
    return sd


def discriminator_state_dict_from_jax(params: Dict) -> StateDict:
    """The JAX package's discriminator tree -> a reference-keyed state_dict
    (the same mapping as the JAX package's `export_discriminator_state_dict`,
    `torch_import.py:474-489`)."""
    sd: StateDict = {}
    _conv(sd, "img_forward.0", params["conv_stem"])
    for i, bp in enumerate(params["blocks"]):
        p = f"img_forward.{i + 1}"
        _conv(sd, f"{p}.residual_conv.0", bp["conv_1"])
        _conv(sd, f"{p}.residual_conv.2", bp["conv_2"])
        if "shortcut_conv" in bp:
            _conv(sd, f"{p}.scale_conv", bp["shortcut_conv"])
        sd[f"{p}.gamma"] = _t(bp["gamma"]).reshape(1)
    _conv(sd, "img_sentence_forward.0", params["conv_joint"])
    _conv(sd, "img_sentence_forward.2", params["conv_logit"])
    return sd


def inception_params_from_jax(params: Dict) -> Dict[str, StateDict]:
    """The JAX package's InceptionV3 params (each conv `w` HWIO, `scale`,
    `bias`; `fc` `w` [2048, 1000], `b`) -> the port's (`models/
    inception.py`: conv `w` OIHW, `fc` `w` [1000, 2048])."""
    out: Dict[str, StateDict] = {}
    for name, p in params.items():
        if name == "fc":
            out[name] = {"w": _t(p["w"]).t().contiguous(), "b": _t(p["b"])}
        else:
            out[name] = {"w": _t(p["w"]).permute(3, 2, 0, 1).contiguous(),
                         "scale": _t(p["scale"]), "bias": _t(p["bias"])}
    return out
