"""Reference-format weights for the port (the port of
`gan_codes_tpu/models/torch_import.py`).

The port's modules carry the reference's state_dict names, so a reference
`gen_N.pth` (or the `generator` entry of a `checkpoint.pt`) and
`text_encoder.pth` load directly. This module infers the architecture from
a state_dict, finds and loads the files, imports a reference `gen_N.pth`
or a whole `checkpoint.pt` (both Adam states included) into a weights
directory `train_entry` resumes from, exports a `gen_N.pth` back, and
carries JAX parameter trees across to reference-keyed state_dicts:

  * Linear weight: JAX [in, out] -> torch [out, in] (transpose)
  * Conv2d weight: JAX HWIO -> torch OIHW
  * block `gamma`: JAX scalar () -> torch shape [1]
  * LSTM: JAX [in, 4H] per direction -> torch [4H, in], gate order
    (i, f, g, o) unchanged
  * InceptionV3 (`inception_params_from_jax`): each folded conv's HWIO
    `w` -> OIHW, `fc.w` [2048, 1000] -> [1000, 2048]

The JAX trees arrive as nested dicts/lists of numpy arrays (for example
`jax.device_get(params)`); nothing here imports JAX. The converter between
JAX and port checkpoint directories, which needs both packages, is
`tools/convert_checkpoint_torch.py`.

    python -m gan_codes_tpu_torch.models.torch_import --gen gen_N.pth --out DIR
    python -m gan_codes_tpu_torch.models.torch_import --ckpt checkpoint.pt \
        --out DIR [--vocab-size V --batch-size B]
    python -m gan_codes_tpu_torch.models.torch_import --export DIR \
        --out gen_N.pth [--epoch N] [--ema]
"""
from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import GANConfig, GeneratorConfig, TextEncoderConfig
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


def _weights_name(epoch, ema: bool) -> str:
    return f"gen_ema_{epoch}.pth" if ema else f"gen_{epoch}.pth"


def latest_generator_epoch(weights_dir: str, ema: bool = False
                           ) -> Optional[int]:
    """The largest N of a `gen_N.pth` (`gen_ema_N.pth` under `ema`) in
    `weights_dir`, or None."""
    pattern = re.compile(r"gen_ema_(\d+)\.pth" if ema else r"gen_(\d+)\.pth")
    return max((int(m.group(1)) for m in map(pattern.fullmatch,
                                               os.listdir(weights_dir)) if m),
               default=None)


def latest_generator_weights(weights_dir: str, ema: bool = False,
                             epoch: Optional[int] = None
                             ) -> Tuple[str, int]:
    """(path, N) of the `gen_N.pth` (`gen_ema_N.pth` under `ema`) with the
    largest N in `weights_dir`, or with N = `epoch`. FileNotFoundError
    otherwise, worded as the JAX package's `restore_generator_tree`."""
    latest = latest_generator_epoch(weights_dir, ema)
    if epoch is None:
        if latest is None:
            raise FileNotFoundError(
                f"No generator weights ({_weights_name('N', ema)}) found in "
                f"{weights_dir}")
        epoch = latest
    path = os.path.join(weights_dir, _weights_name(epoch, ema))
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"No {_weights_name(epoch, ema)} in {weights_dir} (latest is "
            f"{_weights_name(latest, ema)})")
    return path, epoch


# -- import and export: a reference gen_N.pth or checkpoint.pt into a port
# weights directory (`model.py:106-134`: G and D, both Adam states, the
# epoch and the histories), and a gen_N.pth back out of one

def _cfg_from_generator(gcfg: GeneratorConfig) -> GANConfig:
    """A full GANConfig whose companion dims follow the inferred G."""
    import dataclasses

    base = GANConfig.for_image_size(gcfg.image_size,
                                    n_channels=gcfg.n_channels)
    return dataclasses.replace(
        base, generator=gcfg,
        discriminator=dataclasses.replace(
            base.discriminator, sentence_dim=gcfg.sentence_dim),
        text_encoder=dataclasses.replace(
            base.text_encoder, hidden_dim=gcfg.sentence_dim))


def import_generator_checkpoint(torch_path: str, out_dir: str,
                                epoch: int = 0) -> str:
    """A reference `gen_N.pth` (or `checkpoint.pt`) -> a port weights
    directory (`config.json`, `gen_{epoch}.pth`, `gen_ema_{epoch}.pth`)
    that `serve.py` and `generate.py` serve as it is. The reference has no
    EMA generator, so its weights serve as both."""
    from ..train.checkpoint import CheckpointManager

    g, gcfg = load_generator(torch_path)
    mgr = CheckpointManager(out_dir)
    # config first: a crash between the writes leaves config.json without
    # weights (a clean "no weights" error), never weights without it
    mgr.save_config(_cfg_from_generator(gcfg))
    mgr.save_generator(epoch, g.state_dict(), g.state_dict())
    print(f"Imported {torch_path} -> {out_dir}/gen_{epoch}.pth "
          f"({gcfg.image_size}px, n_channels={gcfg.n_channels})")
    return out_dir


def _adam_moments(opt_sd: Dict, model_sd: StateDict
                  ) -> Optional[Tuple[StateDict, StateDict, int]]:
    """A torch Adam state_dict -> (exp_avg by parameter name, exp_avg_sq
    by name, step count), or None where the optimizer never stepped.

    torch keys optimizer state by parameter index in the order the
    optimizer was given its parameters: `model.parameters()` in the
    reference (`model.py:42-43`), whose order is its state_dict's key
    order. The port's modules register each block's `gamma` before its
    children, the reference's after them, so the moments are re-keyed by
    name here and placed by the port's own order (`adam_state_dict`).

    torch creates a parameter's state at its first gradient, so a
    parameter that never had one has no entry: it gets zero moments, and
    a notice names it. optax keeps one count for all parameters, torch a
    step each; the first count found serves every parameter, so a
    substituted parameter's first update is bias-corrected with the
    global count, as the JAX package's import does."""
    keys = list(model_sd)
    ids = [i for g in opt_sd["param_groups"] for i in g["params"]]
    if len(ids) != len(keys):
        raise ValueError(
            f"optimizer tracks {len(ids)} params but the model state_dict "
            f"has {len(keys)}: not a matching checkpoint")
    state = opt_sd.get("state", {})
    if not state:
        return None
    count = next((int(state[i]["step"]) for i in ids if i in state), None)
    if count is None:
        print("[torch_import] optimizer state has no entry for any of this "
              "group's params; fresh Adam init")
        return None
    missing = [k for k, i in zip(keys, ids) if i not in state]
    if missing:
        print(f"[torch_import] {len(missing)} param(s) had no Adam state "
              f"(never received a gradient); zero moments substituted "
              f"(bias correction will use the global step count): "
              f"{missing[:5]}{'...' if len(missing) > 5 else ''}")

    def moment(i, k, field):
        return state[i][field] if i in state else torch.zeros_like(
            model_sd[k])

    return ({k: moment(i, k, "exp_avg") for k, i in zip(keys, ids)},
            {k: moment(i, k, "exp_avg_sq") for k, i in zip(keys, ids)},
            count)


def adam_state_dict(adam: torch.optim.Adam, names: List[str],
                    moments: Tuple[StateDict, StateDict, int]) -> Dict:
    """`adam`'s state_dict holding `moments` (`_adam_moments`' exp_avg
    and exp_avg_sq by name, and the count): `names` are the names of its
    parameters in its order; every parameter's step is the count."""
    exp_avg, exp_avg_sq, count = moments
    sd = adam.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(count)),
                       "exp_avg": exp_avg[n].detach().clone(),
                       "exp_avg_sq": exp_avg_sq[n].detach().clone()}
                   for i, n in enumerate(names)}
    return sd


def imported_state_dict(state, moments, seed: int, epoch: int
                        ) -> Dict[str, Any]:
    """`train.checkpoint.state_to_dict(state)` with Adam `moments` = (G's,
    D's), each an `_adam_moments` triple or None (fresh), placed by the
    port's parameter order, the step G's count, and "rng" a seed: the RNG
    stream cannot be carried across (the reference does not save it;
    JAX's key is not torch's generator), so it restarts from (seed,
    epoch), as the JAX import's `fold_in(PRNGKey(seed), epoch)` does, on
    whichever device resumes the run."""
    from ..train.checkpoint import state_to_dict
    from ..utils.seeding import fold_seed

    for module, opt, m in zip((state.generator, state.discriminator),
                              (state.g_opt, state.d_opt), moments):
        if m is not None:
            names = [n for n, _ in module.named_parameters()]
            opt.adam.load_state_dict(adam_state_dict(opt.adam, names, m))
    state.step = 0 if moments[0] is None else moments[0][2]
    return dict(state_to_dict(state), rng=fold_seed(seed, epoch))


def import_training_checkpoint(ckpt_path: str, out_dir: str,
                               seed: int = 123321,
                               vocab_size: Optional[int] = None,
                               batch_size: Optional[int] = None) -> int:
    """A reference `checkpoint.pt` -> a port weights directory that
    `train_entry --weights OUT_DIR` resumes from (`checkpoint`,
    `config.json`, `histories.json`, `gen_N.pth`, `gen_ema_N.pth`);
    returns the epoch.

    Carries G and D, both Adam states (moments by name, every step the
    global count), the epoch and the six histories; the step is G's Adam
    count (a train step is one G update). `vocab_size` and `batch_size`
    pin what the checkpoint does not record (pass the resumed run's, or
    its config check refuses them). The RNG stream restarts from `seed`
    and the epoch (`imported_state_dict`); `config.json` records `seed`.
    The EMA generator starts as G."""
    import dataclasses

    from ..train.checkpoint import HISTORY_KEYS, CheckpointManager
    from ..train.state import create_train_state

    ck = torch_load_ref(ckpt_path)
    for need in ("generator", "discriminator", "g_optimizer", "d_optimizer",
                 "epoch"):
        if need not in ck:
            raise ValueError(f"{ckpt_path} has no '{need}': expected the "
                             "reference's checkpoint.pt layout")
    gcfg = infer_generator_config(ck["generator"])
    cfg = _cfg_from_generator(gcfg)
    if vocab_size is not None:
        cfg = dataclasses.replace(cfg, text_encoder=dataclasses.replace(
            cfg.text_encoder, vocab_size=vocab_size))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, seed=seed,
        **({"batch_size": batch_size} if batch_size is not None else {})))
    epoch = int(ck["epoch"])
    state = create_train_state(cfg, seed, device="cpu")
    state.generator.load_state_dict(ck["generator"])
    state.g_ema.load_state_dict(ck["generator"])
    state.discriminator.load_state_dict(ck["discriminator"])
    blob = imported_state_dict(
        state, (_adam_moments(ck["g_optimizer"], ck["generator"]),
                _adam_moments(ck["d_optimizer"], ck["discriminator"])),
        seed, epoch)
    histories = {k: [float(v) for v in ck.get(k, [])] for k in HISTORY_KEYS}
    CheckpointManager(out_dir).write(epoch, blob, histories, config=cfg)
    print(f"Imported training checkpoint {ckpt_path} (epoch {epoch + 1}, "
          f"step {blob['step']}) -> {out_dir}")
    return epoch


def reference_order(sd: StateDict) -> StateDict:
    """A port state_dict in the reference modules' key order (their
    `model.parameters()` order): a residual block registers its `gamma`
    after its children there, before them in the port."""
    keys = [k for k in sd if not k.endswith(".gamma")]
    for g in (k for k in sd if k.endswith(".gamma")):
        prefix = g[: -len("gamma")]
        keys.insert(max(i for i, k in enumerate(keys)
                        if k.startswith(prefix)) + 1, g)
    return {k: sd[k] for k in keys}


def export_generator_checkpoint(weights_dir: str, torch_path: str,
                                epoch: Optional[int] = None,
                                use_ema: bool = False) -> str:
    """A port weights directory's `gen_N.pth` (the latest, or `epoch`;
    `gen_ema_N.pth` under `use_ema`) -> a reference `gen_N.pth` at
    `torch_path` in the reference's key order, which the reference's
    `test_generate.py` loads (checked against the architecture its shapes
    give)."""
    path, epoch = latest_generator_weights(weights_dir, use_ema, epoch)
    g, _ = load_generator(path)
    torch.save(reference_order(g.state_dict()), torch_path)
    print(f"Exported {path} -> {torch_path}")
    return torch_path


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


def _cli(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="convert reference torch weights to a port weights "
                    "directory (import) or back (export)")
    direction = ap.add_mutually_exclusive_group(required=True)
    direction.add_argument("--gen", help="IMPORT: path to the torch "
                                         "generator weights "
                                         "(gen_N.pth / checkpoint.pt)")
    direction.add_argument("--ckpt", help="IMPORT the FULL training state "
                                          "(G/D + Adam moments + epoch + "
                                          "histories) from a reference "
                                          "checkpoint.pt; train_entry "
                                          "resumes from the result")
    direction.add_argument("--export", metavar="WEIGHTS_DIR",
                           help="EXPORT: port weights dir to convert back "
                                "to a torch gen_N.pth")
    ap.add_argument("--out", required=True,
                    help="import: output weights directory (becomes "
                         "--weights for generate.py / serve.py / "
                         "train_entry); export: output .pth path")
    ap.add_argument("--epoch", type=int, default=None,
                    help="epoch to import as / export from "
                         "(default: 0 for import, latest for export)")
    ap.add_argument("--ema", action="store_true",
                    help="export the EMA generator instead of the raw one")
    ap.add_argument("--vocab-size", type=int, default=None,
                    help="--ckpt: dataset vocab for the resumed run's "
                         "config (not recorded in the torch checkpoint)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="--ckpt: batch size for the resumed run's config")
    a = ap.parse_args(argv)
    if a.ckpt and a.epoch is not None:
        ap.error("--epoch is not valid with --ckpt: the epoch comes from "
                 "the checkpoint.pt itself")
    if not a.ckpt and (a.vocab_size is not None or a.batch_size is not None):
        ap.error("--vocab-size/--batch-size only apply to --ckpt imports")
    if a.ema and not a.export:
        ap.error("--ema only applies to --export")
    if a.gen:
        import_generator_checkpoint(a.gen, a.out,
                                    epoch=0 if a.epoch is None else a.epoch)
    elif a.ckpt:
        import_training_checkpoint(a.ckpt, a.out, vocab_size=a.vocab_size,
                                   batch_size=a.batch_size)
    else:
        export_generator_checkpoint(a.export, a.out, epoch=a.epoch,
                                    use_ema=a.ema)


if __name__ == "__main__":
    _cli()
