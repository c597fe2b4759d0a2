"""Continuous-batching serve engine for the LM.

Port of ``repro/serve/engine.py``.  A fixed pool of B cache slots; every
engine step decodes ONE token for every active slot, each at its own
position (the vector-``pos`` decode of ``models/lm/attention.py``).  Prompt
consumption and generation use the same step: while a slot still has prompt
tokens left the model's prediction is discarded and the next prompt token
is fed (ragged prefill-by-decode), so requests of different lengths join
and leave the batch at any step.  Finished slots are freed and refilled
from the queue.  The engine runs no prefill, so it never launches the
flash-attention kernel.  It serves the dense and MoE families (a MoE step
caps over all B slots, inactive ones feeding token 0, as the reference's
does).  The other families raise, each for its own reason:

* a recurrent cache (SSM, hybrid): the reference admits a request into a
  slot without resetting the slot's cache, and an SSM decode ignores the
  position, so a reused slot would continue the previous request's state
  (ROADMAP.md §3);
* a cross-attention cache (VLM, audio): the reference's engine only ever
  decodes, so ``xk`` / ``xv`` stay the zeros of ``cache_zeros`` and every
  request would attend to an empty image or audio memory (ROADMAP.md §3).

Serve those with ``models.lm.serve.prefill`` / ``decode_step``.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.lm import serve
from repro_torch.models.lm.model import LM


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    _consumed: int = 0         # prompt tokens already fed

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class ServeEngine:
    def __init__(self, lm: LM, params, *, max_batch: int, s_max: int,
                 sample: Optional[Callable] = None, device="cuda"):
        fam = lm.cfg.family
        if fam in ("ssm", "hybrid"):
            raise NotImplementedError(
                f"ServeEngine over the {fam!r} family: a reused slot would "
                f"keep the previous request's recurrent state (ROADMAP.md "
                f"§3); serve it with models.lm.serve.prefill / decode_step")
        if fam in ("vlm", "audio"):
            raise NotImplementedError(
                f"ServeEngine over the {fam!r} family: the engine only "
                f"decodes, so the cross-attention caches xk / xv would stay "
                f"zeros and every request would attend to an empty "
                f"{'image' if fam == 'vlm' else 'audio'} memory (ROADMAP.md "
                f"§3); serve it with models.lm.serve.prefill / decode_step")
        dev = resolve_device(device)
        if lm.device != dev:
            raise ValueError(f"model on {lm.device}, engine on {dev}; "
                             f"move the model or pass device={str(lm.device)!r}")
        self.lm = lm
        self.params = params
        self.device = dev
        self.b = max_batch
        self.s_max = s_max
        self.sample = sample or (lambda logits: int(np.argmax(logits)))
        self.cache = serve.cache_zeros(lm, max_batch, s_max)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.pos = np.zeros(max_batch, np.int64)     # next write position
        self.queue: Deque[Request] = deque()
        self.finished: Dict[int, Request] = {}
        self._rid = itertools.count()

    # ------------------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 16) -> int:
        rid = next(self._rid)
        self.queue.append(Request(rid, list(prompt), max_new_tokens))
        return rid

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _admit(self):
        for i in range(self.b):
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.popleft()
                self.pos[i] = 0

    def step(self) -> int:
        """One engine step: decode one token for every active slot.
        Returns the number of active slots processed."""
        self._admit()
        if self.n_active == 0:
            return 0
        token = np.zeros((self.b, 1), np.int64)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if req._consumed < len(req.prompt):
                token[i, 0] = req.prompt[req._consumed]
            else:
                token[i, 0] = req.generated[-1]
        pos_vec = np.where([s is not None for s in self.slots], self.pos, 0)
        self.cache, logits = serve.decode_step(
            self.lm, self.params, self.cache,
            torch.from_numpy(token).to(self.device),
            torch.from_numpy(pos_vec).to(self.device))
        logits_np = logits[:, 0, : self.lm.cfg.vocab].float().cpu().numpy()

        n = 0
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            n += 1
            self.pos[i] += 1
            if req._consumed < len(req.prompt):
                req._consumed += 1
                if req._consumed == len(req.prompt):
                    req.generated.append(self.sample(logits_np[i]))
            else:
                req.generated.append(self.sample(logits_np[i]))
            if req.done or self.pos[i] >= self.s_max:
                self.finished[req.rid] = req
                self.slots[i] = None
        return n

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        for _ in range(max_steps):
            if self.n_active == 0 and not self.queue:
                break
            self.step()
        return self.finished
