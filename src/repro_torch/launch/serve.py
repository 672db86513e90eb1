"""Batched serving launcher: slot-based continuous batching over a shared
KV cache.

The port of the JAX package's ``launch/serve.py``, mirrored exactly so
that greedy tokens agree on the same weights: a prompt is fed token by
token through decode steps, all active slots then decode in lockstep at
one shared position (the largest slot position), and the next token is
the argmax over the padded vocabulary.  The server runs on the card
unless the caller passes ``device="cpu"``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
        --reduced --device cpu --requests 12 --max-new 16
"""
from __future__ import annotations

import argparse
import collections
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_cache, init_params


@dataclass
class Request:
    id: int
    prompt: np.ndarray               # (S,) int32
    max_new: int
    out: list = field(default_factory=list)
    submitted: float = 0.0
    finished: Optional[float] = None


class BatchServer:
    """Fixed-slot decode batching: prefill one request at a time, decode
    all active slots in lockstep with a shared cache.  ``params`` (the
    port's tree, on ``device``) replaces the seeded random weights."""

    def __init__(self, cfg, *, slots=4, max_len=128, seed=0,
                 compute_dtype=torch.float32, params=None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.dtype = compute_dtype
        self.params = params if params is not None else \
            init_params(cfg, seed, device=self.device)
        self.queue: collections.deque = collections.deque()
        self.active: dict = {}           # slot -> Request
        self.caches = init_cache(cfg, slots, max_len, compute_dtype,
                                 device=self.device)
        self.pos = np.zeros(slots, np.int32)
        self.done: list = []
        self.steps = 0                   # decode steps run

    def _decode(self, tokens: np.ndarray, pos: int):
        self.steps += 1
        logits, self.caches = decode_step(
            self.params, self.cfg, self.caches,
            torch.from_numpy(tokens).to(self.device), pos,
            compute_dtype=self.dtype)
        return logits

    def submit(self, req: Request):
        req.submitted = time.time()
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.slots):
            if slot in self.active or not self.queue:
                continue
            req = self.queue.popleft()
            # prefill: feed prompt tokens through decode steps
            for tok in req.prompt:
                t = np.zeros((self.slots, 1), np.int32)
                t[slot, 0] = tok
                logits = self._decode(t, int(self.pos[slot]))
                self.pos[slot] += 1
            req.out.append(int(torch.argmax(logits[slot, -1])))
            self.active[slot] = req

    def _decode_tick(self):
        if not self.active:
            return
        t = np.zeros((self.slots, 1), np.int32)
        for slot, req in self.active.items():
            t[slot, 0] = req.out[-1]
        pos = int(max(self.pos[s] for s in self.active))
        logits = self._decode(t, pos)
        for slot in list(self.active):
            req = self.active[slot]
            req.out.append(int(torch.argmax(logits[slot, -1])))
            self.pos[slot] += 1
            if len(req.out) >= req.max_new or \
                    self.pos[slot] >= self.max_len - 1:
                req.finished = time.time()
                self.done.append(req)
                del self.active[slot]

    def run(self):
        while self.queue or self.active:
            self._admit()
            self._decode_tick()
        return self.done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    rng = np.random.default_rng(0)
    server = BatchServer(cfg, slots=args.slots, device=args.device)
    t0 = time.time()
    for i in range(args.requests):
        plen = int(rng.integers(4, 12))
        server.submit(Request(i, rng.integers(
            0, cfg.vocab_size, plen).astype(np.int32), args.max_new))
    done = server.run()
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s)")
    return done


if __name__ == "__main__":
    main()
