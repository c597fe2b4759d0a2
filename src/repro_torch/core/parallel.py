"""Host packing pool -- the paper's Sec. 3.4 CPU-init-thread overlap at
batch granularity.

``prefetch(items, prepare, depth=d, n_threads=n)`` runs ``prepare`` on
worker threads up to ``depth`` items ahead of the consumer and yields the
results in input order.  The serve engine's ``prepare`` collates a batch
and issues its pinned-host -> device copies on a side stream, so batch
i+1 packs and copies while the card runs batch i.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator


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
