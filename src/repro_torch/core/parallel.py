"""Parallel subgraph scheduling -- the paper's Sec. 3.4: independent
relation modules on CUDA streams, and host packing overlapped with the
card.

* ``run_fused(fns, args)`` runs independent module functions concurrently:
  on the card each is launched on its own ``torch.cuda.Stream``, ordered
  after the caller's stream by an event, and the caller's stream then
  waits on all of them; nothing blocks the host.
* ``run_sequential(fns, args)`` is the module-by-module baseline the paper
  measures against: on the card it synchronises after every function.
* Given CPU tensors, both run the functions in order.
* ``prefetch(items, prepare, depth=d, n_threads=n)`` runs ``prepare`` on
  worker threads up to ``depth`` items ahead of the consumer and yields
  the results in input order.  The serve engine's ``prepare`` collates a
  batch and issues its pinned-host -> device copies on a side stream, so
  batch i+1 packs and copies while the card runs batch i.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence)

import torch

# side streams of run_fused, per device, grown on demand and reused
_STREAMS: Dict[torch.device, List[torch.cuda.Stream]] = {}


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _card_of(args) -> Optional[torch.device]:
    """The CUDA device the arguments live on, or None for CPU tensors."""
    for t in _tensors(list(args)):
        return t.device if t.device.type == "cuda" else None
    return None


def run_fused(fns: Sequence[Callable], args: Sequence[tuple]) -> tuple:
    """``tuple(f(*a) for f, a in zip(fns, args))`` with the functions
    running concurrently on side streams when the arguments are on a
    card."""
    dev = _card_of(args)
    if dev is None:
        return tuple(f(*a) for f, a in zip(fns, args))
    main = torch.cuda.current_stream(dev)
    pool = _STREAMS.setdefault(dev, [])
    while len(pool) < len(fns):
        pool.append(torch.cuda.Stream(dev))
    ready = torch.cuda.Event()
    ready.record(main)
    outs = []
    for f, a, s in zip(fns, args, pool):
        s.wait_event(ready)
        with torch.cuda.stream(s):
            outs.append(f(*a))
    for o, s in zip(outs, pool):
        main.wait_stream(s)
        # outputs were allocated on the side stream: tell the allocator
        # the caller's stream uses them too before it may reuse them
        for t in _tensors(o):
            t.record_stream(main)
    return tuple(outs)


def run_sequential(fns: Sequence[Callable], args: Sequence[tuple]) -> tuple:
    """The functions one after another, the card synchronised after each
    (the module-by-module baseline)."""
    dev = _card_of(args)
    outs = []
    for f, a in zip(fns, args):
        outs.append(f(*a))
        if dev is not None:
            torch.cuda.synchronize(dev)
    return tuple(outs)


def prefetch(items: Iterable, prepare: Callable, *, depth: int = 1,
             n_threads: int = 3) -> Iterator:
    """Yield ``prepare(item)`` for each item, in order, with up to
    ``depth`` items prepared ahead on a pool of ``n_threads``."""
    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        futs: deque = deque()
        for x in items:
            futs.append(pool.submit(prepare, x))
            if len(futs) > depth:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()
