#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package into one of the PyTorch port.

A run trained with ``scripts/train.py`` (an orbax directory) becomes a
directory that ``scripts/train_torch.py --checkpoint`` resumes from and
``scripts/play_torch.py`` evaluates:

  - the whole saved tree is restored onto a CPU device, its target built
    from the checkpoint's own metadata (as the JAX ``restore_params``
    does), so a checkpoint written on a TPU converts on any host;
  - the params go through ``swarmacb_torch.convert.flax_to_state_dict``;
  - the Adam state of ``optax.inject_hyperparams(optax.adam)`` becomes
    PyTorch's: ``count`` → ``step``, ``mu`` → ``exp_avg``, ``nu`` →
    ``exp_avg_sq``, each moment under its parameter's name with the
    params' transposes (``fc_out`` is square, so only a name-by-name
    mapping keeps it right), ordered as the port's optimizer holds its
    parameters (actor, then critic);
  - ``metadata.json`` is copied, ``global_step`` and ``update_count`` kept.

This script imports both packages; the port itself imports no JAX.

Usage:
    python scripts/convert_jax_checkpoint.py checkpoints/DirGate_dandelion/poca_final \
        checkpoints_torch/DirGate_dandelion/poca_final
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from swarmacb_torch.agents.checkpoint import (  # noqa: E402
    METADATA_FILE, STATE_FILE, actor_from_metadata)
from swarmacb_torch.config import DirectionalGateEnvCfg, POCAConfig  # noqa: E402
from swarmacb_torch.convert import flax_to_state_dict  # noqa: E402
from swarmacb_torch.models.networks import POCACritic  # noqa: E402


def restore_tree(path: pathlib.Path) -> dict:
    """The whole saved tree ({"params", "opt_state"}) on a CPU device."""
    import jax
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    sharding = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    target = jax.tree_util.tree_map(
        lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=sharding),
        ckptr.metadata(path).item_metadata)
    return ckptr.restore(path, target)


def _field(node, name: str, index: int):
    """A field of a restored named tuple: orbax may hand it back as the
    tuple, a dict or a list."""
    if isinstance(node, dict):
        return node[name]
    return getattr(node, name) if hasattr(node, name) else node[index]


def adam_state(opt_state) -> tuple[int, dict, dict, dict]:
    """(count, mu, nu, hyperparams) of an ``inject_hyperparams(adam)``
    state: InjectStatefulHyperparamsState(count, hyperparams,
    hyperparams_states, inner_state), inner_state = (ScaleByAdamState(count,
    mu, nu), EmptyState())."""
    hyper = _field(opt_state, "hyperparams", 1)
    adam = _field(opt_state, "inner_state", 3)[0]
    count = int(_field(adam, "count", 0))
    return count, _field(adam, "mu", 1), _field(adam, "nu", 2), hyper


def port_modules(meta: dict):
    """The port's actor and critic for the metadata, on the meta device:
    their parameter names and order, which PyTorch's Adam keys by index."""
    variant = meta.get("variant", "dandelion")
    num_agents = DirectionalGateEnvCfg(variant=variant).num_agents
    act_dim_critic = meta["num_actions"] if meta["discrete"] else meta["act_dim"]
    actor = actor_from_metadata(meta)
    with torch.device("meta"):
        critic = POCACritic(state_dim=meta["state_dim"], act_dim=act_dim_critic,
                            num_agents=num_agents, hidden=meta["hidden_dim"],
                            num_heads=POCAConfig().critic_num_heads,
                            num_layers=meta["num_layers"])
    return actor, critic


def _state_dicts(tree) -> dict:
    return {net: flax_to_state_dict(tree[net]) for net in ("actor", "critic")}


def convert(src: str | pathlib.Path, dst: str | pathlib.Path) -> pathlib.Path:
    src, dst = pathlib.Path(src).absolute(), pathlib.Path(dst).absolute()
    meta = json.loads((src / METADATA_FILE).read_text())
    tree = restore_tree(src)
    count, mu, nu, hyper = adam_state(tree["opt_state"])
    print(f"[convert] {src}: opt_state restored as "
          f"{type(tree['opt_state']).__name__}, adam count {count}")

    params, exp_avg, exp_avg_sq = _state_dicts(tree["params"]), _state_dicts(mu), _state_dicts(nu)
    actor, critic = port_modules(meta)
    order = []
    for net, module in (("actor", actor), ("critic", critic)):
        names = [n for n, _ in module.named_parameters()]
        if set(names) != set(params[net]):
            raise ValueError(f"{net}: the port's parameters {sorted(names)} are not "
                             f"the checkpoint's {sorted(params[net])}")
        order += [(net, n) for n in names]
    optimizer = torch.optim.Adam(
        [*actor.parameters(), *critic.parameters()],
        lr=float(hyper["learning_rate"]), eps=float(hyper["eps"]),
        betas=(float(hyper["b1"]), float(hyper["b2"])))
    step = torch.tensor(float(count), dtype=torch.float32)
    state = {
        **params,
        "optimizer": {
            "state": {i: {"step": step.clone(), "exp_avg": exp_avg[net][n],
                          "exp_avg_sq": exp_avg_sq[net][n]}
                      for i, (net, n) in enumerate(order)},
            "param_groups": optimizer.state_dict()["param_groups"],
        },
    }
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    torch.save(state, dst / STATE_FILE)
    (dst / METADATA_FILE).write_text(json.dumps(meta))
    print(f"[convert] {src} → {dst} (step {meta['global_step']}, "
          f"{meta['update_count']} updates)")
    return dst


def main(argv=None) -> pathlib.Path:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="checkpoint directory of the JAX package (orbax)")
    p.add_argument("dst", help="checkpoint directory to write for the port")
    args = p.parse_args(argv)
    return convert(args.src, args.dst)


if __name__ == "__main__":
    main()
