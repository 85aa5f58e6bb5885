"""Model replicas: the serverless "instance" backed by a real torch model.

Counterpart of ``repro.serving.engine``.  Cold start = weight init on the
device + one decode step + cache reset, ended by a device synchronize before
the clock is read (PyTorch runs eagerly, so there is no compile; the first
step still pays the CUDA kernels' first-use costs).  A warm replica serves up
to ``max_slots`` requests at once via slot-based continuous batching: every
``step()`` advances all active slots by one token (consuming prompt tokens
first, then generating).

Unlike the JAX replica, ``add`` zeroes the slot's rows of a recurrent cache
(the ssm family's ``S``, ``tshift``, ``cshift``, the hybrid family's
``ssm_h``, ``conv``; ``registry.reset_slot``),
so a request placed in a reused slot starts from a fresh state; the JAX
replica resets only the position, which masks a stale attention cache but
not a recurrent one (ROADMAP Queue 3).  Attention caches are left as they are.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.models import registry


@dataclasses.dataclass
class ServeRequest:
    rid: int
    fn: int
    prompt: list[int]
    max_new_tokens: int = 16
    arrival_t: float = 0.0
    dispatch_t: float = float("nan")
    first_token_t: float = float("nan")
    done_t: float = float("nan")
    output: list[int] = dataclasses.field(default_factory=list)
    cold: bool = False

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens


class ModelReplica:
    """One warm instance: resident weights + KV cache on one device."""

    def __init__(self, cfg: ModelConfig, *, max_slots: int = 4,
                 max_seq: int = 256, seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        t0 = time.monotonic()
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        #: decode steps run, the cold-start step included
        self.decode_steps = 0
        self.params = registry.init_params(cfg, device=self.device, seed=seed)
        self.cache = registry.init_cache(cfg, max_slots, max_seq, device=self.device)
        # first step (part of the cold start, like a first-request warmup)
        tok = torch.zeros((max_slots, 1), dtype=torch.int32, device=self.device)
        pos = torch.zeros((max_slots,), dtype=torch.int32, device=self.device)
        self._decode(tok, pos)
        for layer in self.cache:
            for t in layer.values():
                t.zero_()
        synchronize(self.device)
        self.cold_start_s = time.monotonic() - t0

        self.slots: list[Optional[ServeRequest]] = [None] * max_slots
        self._pos = np.zeros(max_slots, np.int32)
        self._next_tok = np.zeros(max_slots, np.int32)
        self._prompt_left: list[list[int]] = [[] for _ in range(max_slots)]
        self.idle_since: float = time.monotonic()
        self.created_t = time.monotonic()

    def _decode(self, tokens, pos):
        self.decode_steps += 1
        logits, self.cache = registry.decode_step(self.cfg, self.params, self.cache,
                                                  tokens, pos)
        return logits

    # -- memory accounting (the paper's per-instance footprint) ------------------

    def memory_bytes(self) -> int:
        leaves = registry.leaves(self.params) + registry.leaves(self.cache)
        return int(sum(t.numel() * t.element_size() for t in leaves))

    # -- slot management -----------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return sum(s is None for s in self.slots)

    @property
    def in_flight(self) -> int:
        return self.max_slots - self.free_slots

    def add(self, req: ServeRequest, now: float) -> bool:
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = req
                req.dispatch_t = now
                self._pos[i] = 0
                registry.reset_slot(self.cfg, self.cache, i)
                prompt = req.prompt[:self.max_seq - req.max_new_tokens - 1]
                self._prompt_left[i] = list(prompt[1:])
                self._next_tok[i] = prompt[0] if prompt else 0
                return True
        return False

    # -- the serving loop body --------------------------------------------------------

    def step(self, now: float) -> list[ServeRequest]:
        """Advance every active slot one token; return completed requests."""
        if self.in_flight == 0:
            return []
        # host-to-device copies; the stream is idle here (the previous step
        # ended in its host sync), so they wait on no device work
        toks = torch.tensor(self._next_tok[:, None], device=self.device)
        pos = torch.tensor(self._pos, device=self.device)
        logits = self._decode(toks, pos)
        # the step's one host sync: argmax ids (first index among ties) to the CPU
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy().astype(np.int32)

        finished = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self._pos[i] += 1
            if self._prompt_left[i]:
                self._next_tok[i] = self._prompt_left[i].pop(0)
                continue
            # generating
            if not req.output and np.isnan(req.first_token_t):
                req.first_token_t = now
            req.output.append(int(nxt[i]))
            self._next_tok[i] = nxt[i]
            if req.done or self._pos[i] >= self.max_seq - 1:
                req.done_t = now
                finished.append(req)
                self.slots[i] = None
        if self.in_flight == 0:
            self.idle_since = now
        return finished
