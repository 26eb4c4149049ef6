#!/usr/bin/env python3
"""Convert a weights directory of the JAX package into one of the PyTorch
port (`gan_codes_tpu_torch`), or back, so a run moves between a TPU host
and a CUDA card and resumes there:

    python tools/convert_checkpoint_torch.py --to-port JAX_DIR --out PORT_DIR
    python tools/convert_checkpoint_torch.py --to-jax PORT_DIR --out JAX_DIR

A JAX directory holds the Orbax `checkpoint` (the TrainState), a `gen_N`
tree per saved epoch (`g_params`, `g_ema_params`), `config.json` and
`histories.json`; a port directory holds `checkpoint` (one `torch.save`
of `train.checkpoint.state_to_dict`), `gen_N.pth` and `gen_ema_N.pth`,
`config.json` and `histories.json`. Both read one `config.json` layout.

G, D and the EMA G go through the port's `generator_state_dict_from_jax`
/ `discriminator_state_dict_from_jax` one way and the JAX package's
`convert_torch_*_state_dict` the other (transposes only, so the bytes
carry). Each optax chain's `ScaleByAdamState` (`mu`, `nu`, `count`) maps
onto torch Adam's `exp_avg`, `exp_avg_sq` and `step` by parameter name,
through the same layout maps, each parameter's step the count. The step
carries across. The RNG stream cannot (JAX's key is not torch's
generator): the written state's stream restarts from the config's seed
and the epoch, as the reference `checkpoint.pt` import does, and the
script says so.

It imports both packages, so it runs where JAX runs (the port itself
never imports JAX); the directory it writes moves to the other machine.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import types
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gan_codes_tpu import config as jcfg  # noqa: E402
from gan_codes_tpu.models import torch_import as jimport  # noqa: E402
from gan_codes_tpu.train import checkpoint as jckpt  # noqa: E402
from gan_codes_tpu.train import state as jstate  # noqa: E402
from gan_codes_tpu_torch import config as pcfg  # noqa: E402
from gan_codes_tpu_torch.models import torch_import as pimport  # noqa: E402
from gan_codes_tpu_torch.train import checkpoint as pckpt  # noqa: E402
from gan_codes_tpu_torch.train.state import create_train_state  # noqa: E402
from gan_codes_tpu_torch.utils.jsonio import restore_nonfinite  # noqa: E402


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def find_adam(opt_state) -> Optional[optax.ScaleByAdamState]:
    """The ScaleByAdamState inside an optax chain state (as the JAX
    package's `_inject_adam` finds it), or None."""
    if isinstance(opt_state, optax.ScaleByAdamState):
        return opt_state
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields"):
        for s in opt_state:
            found = find_adam(s)
            if found is not None:
                return found
    return None


def _read_config(directory: str) -> dict:
    path = os.path.join(directory, "config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} missing: the architecture cannot "
                                "be rebuilt without it")
    with open(path) as f:
        return json.load(f)


def _reseeded(seed: int, epoch: int) -> None:
    print(f"[convert] the RNG stream is not carried: it restarts from the "
          f"config's seed {seed} and epoch {epoch}")


def jax_to_port(src: str, out: str) -> Optional[int]:
    """A JAX weights directory -> a port one; returns the checkpoint's
    epoch (None when `src` holds only gen_N trees)."""
    blob_cfg = _read_config(src)
    jc = jcfg.GANConfig.from_dict(blob_cfg)
    pc = pcfg.GANConfig.from_dict(blob_cfg)
    jmgr = jckpt.CheckpointManager(src)
    pmgr = pckpt.CheckpointManager(out)
    pmgr.save_config(pc)  # config first, as the importers write it
    to_g = pimport.generator_state_dict_from_jax
    to_d = pimport.discriminator_state_dict_from_jax
    gens = sorted(int(m.group(1)) for m in map(
        re.compile(r"gen_(\d+)").fullmatch, os.listdir(src)) if m)
    for ep in gens:
        tree, _ = jmgr.restore_generator_tree(jc.generator, ep)
        pmgr.save_generator(ep, to_g(_np(tree["g_params"])),
                            to_g(_np(tree["g_ema_params"])))
    if not jmgr.has_checkpoint():
        print(f"[convert] {src}: gen_N {gens} -> {out} (no checkpoint)")
        return None
    template = jax.eval_shape(lambda k: jstate.create_train_state(k, jc),
                              jax.random.PRNGKey(0))
    js, epoch, histories = jmgr.restore(template)
    js = jax.device_get(js)
    state = create_train_state(pc, pc.train.seed, device="cpu")
    state.generator.load_state_dict(to_g(_np(js.g_params)))
    state.g_ema.load_state_dict(to_g(_np(js.g_ema_params)))
    state.discriminator.load_state_dict(to_d(_np(js.d_params)))
    moments = []
    for opt_state, to_sd in ((js.g_opt_state, to_g), (js.d_opt_state, to_d)):
        adam = find_adam(opt_state)
        moments.append(None if adam is None else (
            to_sd(_np(adam.mu)), to_sd(_np(adam.nu)), int(adam.count)))
    blob = pimport.imported_state_dict(state, moments, pc.train.seed, epoch)
    blob["step"] = int(js.step)
    pmgr.write(epoch, blob, histories, config=pc)
    _reseeded(pc.train.seed, epoch)
    print(f"[convert] {src} (epoch {epoch}, step {blob['step']}, gen_N "
          f"{gens}) -> {out}")
    return epoch


def port_to_jax(src: str, out: str) -> Optional[int]:
    """A port weights directory -> a JAX one; returns the checkpoint's
    epoch (None when `src` holds only gen_N.pth files)."""
    blob_cfg = _read_config(src)
    jc = jcfg.GANConfig.from_dict(blob_cfg)
    jmgr = jckpt.CheckpointManager(out)
    jmgr.save_config(jc)

    def to_g(sd):
        return jimport.convert_torch_generator_state_dict(sd, jc.generator)

    def to_d(sd):
        return jimport.convert_torch_discriminator_state_dict(
            sd, jc.discriminator)

    gens = sorted(int(m.group(1)) for m in map(
        re.compile(r"gen_(\d+)\.pth").fullmatch, os.listdir(src)) if m)
    for ep in gens:
        g = pimport.torch_load_ref(os.path.join(src, f"gen_{ep}.pth"))
        ema_path = os.path.join(src, f"gen_ema_{ep}.pth")
        ema = pimport.torch_load_ref(ema_path) if os.path.exists(ema_path) \
            else g  # a reference-format directory: no EMA
        jmgr.save_generator(ep, types.SimpleNamespace(
            g_params=to_g(g), g_ema_params=to_g(ema)))
    if not os.path.exists(os.path.join(src, "checkpoint")):
        print(f"[convert] {src}: gen_N {gens} -> {out} (no checkpoint)")
        return None
    blob = torch.load(os.path.join(src, "checkpoint"), map_location="cpu",
                      weights_only=True)
    with open(os.path.join(src, "histories.json")) as f:
        histories = restore_nonfinite(json.load(f))
    epoch = int(histories.pop("epoch"))
    g_params, d_params = to_g(blob["generator"]), to_d(blob["discriminator"])
    g_tx, d_tx = jstate.make_optimizers(jc)
    opt_states = []
    for tx, params, opt, key, conv in (
            (g_tx, g_params, "g_opt", "generator", to_g),
            (d_tx, d_params, "d_opt", "discriminator", to_d)):
        m = pimport._adam_moments(blob[opt], blob[key])
        opt_states.append(jimport._inject_adam(
            tx.init(params), None if m is None else (
                conv(m[0]), conv(m[1]), m[2])))
    state = jstate.TrainState(
        step=jnp.asarray(int(blob["step"]), jnp.int32), g_params=g_params,
        d_params=d_params, g_opt_state=opt_states[0],
        d_opt_state=opt_states[1], g_ema_params=to_g(blob["g_ema"]),
        rng=jax.random.fold_in(jax.random.PRNGKey(jc.train.seed), epoch))
    jmgr.save(epoch, state, histories, config=jc)
    _reseeded(jc.train.seed, epoch)
    print(f"[convert] {src} (epoch {epoch}, step {int(blob['step'])}, gen_N "
          f"{gens}) -> {out}")
    return epoch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="convert a weights directory between the JAX package "
                    "and the PyTorch port")
    direction = ap.add_mutually_exclusive_group(required=True)
    direction.add_argument("--to-port", metavar="JAX_DIR",
                           help="a JAX weights directory to convert into "
                                "a port one")
    direction.add_argument("--to-jax", metavar="PORT_DIR",
                           help="a port weights directory to convert into "
                                "a JAX one")
    ap.add_argument("--out", required=True, help="the directory to write")
    a = ap.parse_args(argv)
    if a.to_port:
        jax_to_port(a.to_port, a.out)
    else:
        port_to_jax(a.to_jax, a.out)


if __name__ == "__main__":
    main()
