"""Weights from the seed, handed to the program and to the reference alike.

The benchmark draws every weight itself, on the device, one
``torch.randn`` call per kind of leaf with the layers stacked (``wq`` of
all layers in one call), from a ``torch.Generator`` seeded from
``--seed``.  The program gets them written into its own state; the
reference draws them again.  Nothing the program made reaches the
reference.

The kinds of leaves, their shapes and the port's layout in their names
(``(kind, layer)``) are the configuration's family's
(``portbench/families/<family>.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from portbench import families

Leaf = Tuple[str, Optional[int]]


def subseed(seed: int, stream: int, index: int) -> int:
    """A generator seed for draw ``index`` of ``stream`` under ``seed``."""
    return (int(seed) * 2 ** 24 + stream * 2 ** 16 + index) % 2 ** 63


def draw(cfg: Dict[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every kind of leaf, stacked over the layers, float32."""
    out = {}
    gen = torch.Generator(device=device)
    for i, (name, (shape, std)) in enumerate(sorted(
            families.of(cfg).shapes(cfg).items())):
        if std == 0.0:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
            continue
        gen.manual_seed(subseed(seed, 1, i))
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        out[name] = x.mul_(std)
    return out


def get(stacked: Dict[str, torch.Tensor], leaf: Leaf) -> torch.Tensor:
    kind, layer = leaf
    return stacked[kind] if layer is None else stacked[kind][layer]


# the program's layout: one tree per sched layer (embed, blocks, final)

def _map(t: Any, fn) -> Any:
    if isinstance(t, dict):
        return {k: _map(v, fn) for k, v in t.items()}
    return fn(t)


def named_leaves(t: Any) -> Iterator[Leaf]:
    """The names of ``t`` in the port's tree order (dict keys sorted)."""
    if isinstance(t, dict):
        for k in sorted(t):
            yield from named_leaves(t[k])
    else:
        yield t


def program_params(cfg: Dict[str, Any], stacked: Dict[str, torch.Tensor]):
    """The port's parameter tree (``{"embed", "layers", "final"}``), its
    leaves views of ``stacked``."""
    trees = [_map(t, lambda leaf: get(stacked, leaf))
             for t in families.of(cfg).program_trees(cfg)]
    return {"embed": trees[0], "layers": trees[1:-1], "final": trees[-1]}


def load_into_state(cfg, stacked, trainer, state) -> None:
    """Write ``stacked`` into a ZeRO state's flat parameter buffers (one
    rank: a buffer is the whole flat), through the port's own layout."""
    from repro_torch import tree
    from repro_torch.dist.collectives import flatten_tree
    if trainer.axis_size != 1:
        raise ValueError("the weights are written on one rank")
    trees = families.of(cfg).program_trees(cfg)
    for l, (names, spec) in enumerate(zip(trees, trainer.specs)):
        t = _map(names, lambda leaf: get(stacked, leaf))
        if tree.structure(t) != spec.treedef:
            raise ValueError(f"sched layer {l}: the port's parameter tree "
                             f"is not the layout the benchmark writes")
        with torch.no_grad():
            state["flat_params"][l].copy_(flatten_tree(t, spec))


def state_leaves(cfg, trainer, flats) -> Iterator[Tuple[Leaf, torch.Tensor]]:
    """``(name, tensor)`` for every leaf of per-sched-layer flat buffers
    (parameters or a moment), read through the port's layout."""
    from repro_torch import tree
    from repro_torch.dist.collectives import unflatten_tree
    for names, spec, flat in zip(families.of(cfg).program_trees(cfg),
                                  trainer.specs, flats):
        values = tree.leaves(unflatten_tree(flat, spec))
        yield from zip(named_leaves(names), values)
