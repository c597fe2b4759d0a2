"""Backbone stack: the declarative spec and the one stack executor.

``wiring`` draws the DeepGEN-style reuse pattern: ``"plain"``
(h_i = f_i(h_{i-1})), ``"residual"`` (+ h_{i-1} from the second layer on)
and ``"dense"`` (+ Σ of all previous layer states).  Skips start at the
second layer, so a depth-1 residual or dense stack is the plain one.
``remat`` recomputes each layer in the backward instead of keeping its
activations (``torch.utils.checkpoint``, non-reentrant).  Every kernel on
the path is deterministic, so the recompute is bit-identical and the
gradients equal those without remat.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from torch.utils.checkpoint import checkpoint

WIRINGS = ("plain", "residual", "dense")


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    """Declarative stack spec; ``depth`` must match the layer count."""
    depth: int = 2
    hidden: int = 64
    wiring: str = "plain"        # plain | residual | dense
    remat: bool = False          # recompute each layer in the backward

    def __post_init__(self):
        if self.wiring not in WIRINGS:
            raise ValueError(f"unknown wiring {self.wiring!r}; "
                             f"expected one of {WIRINGS}")


def spec_for(layers: Sequence, hidden: int, *,
             wiring: str = "plain") -> BackboneSpec:
    """The spec describing an existing layer sequence."""
    return BackboneSpec(depth=len(layers), hidden=hidden, wiring=wiring)


def _tree_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def apply_stack(layers: Sequence, state: tuple, body: Callable,
                spec: BackboneSpec, const=None) -> tuple:
    """Run the ``state`` tuple through ``layers`` with the spec's wiring.
    ``body(layer, state, const) -> state`` is one layer's compute."""
    if len(layers) != spec.depth:
        raise ValueError(f"spec.depth={spec.depth} but {len(layers)} "
                         f"layers given")
    acc = None                      # Σ of post-wiring layer states
    for i, lp in enumerate(layers):
        if spec.remat:
            y = checkpoint(body, lp, state, const, use_reentrant=False)
        else:
            y = body(lp, state, const)
        if i and spec.wiring == "residual":
            y = _tree_add(y, state)
        elif i and spec.wiring == "dense":
            y = _tree_add(y, acc)
        acc = y if acc is None else _tree_add(acc, y)
        state = y
    return state
