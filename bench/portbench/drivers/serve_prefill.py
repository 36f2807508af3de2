"""Solo prefill, the time to the first token: one client, one request at a
time, through the calls the port's ``launch.serve.generate`` makes before
its first token: ``train.step.make_prefill_step`` on the ``(1, L)``
prompt, then the greedy pick brought back to the host. Each request is
timed from handing the prompt over to the token on the host. The window
runs whole cycles of the mix's sizes, each in its own seeded order and
each started only where it would end inside the window
(``portbench.window``), so every run's tail is over the same set of sizes
(the port's prefill pads to 1024-token tiles, so a tail taken over other
sizes would jump by a tile).

Mix keys: ``prompt_len`` (a ``traffic.lengths`` spec, with ``count``
sizes in a cycle), ``warm`` (how many of the sizes, spread over the range,
set-up runs once), ``sample_requests`` and ``limits``.

The check: a seeded sample of the window's requests, the longest among
them, through the plain f32 reference; the number compared is the largest
gap between the program's and the reference's last-position logits, over
the reference's root mean square logit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import model, traffic, window
from reference import dense_lm


class Driver:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.cfg, self.mix, self.rec = ctx.cfg, ctx.mix, ctx.rec
        self.requests = []             # (prompt, ttft_s, logits on host)

    def setup(self) -> None:
        from repro_torch.train import step

        self.pcfg = model.port_config(self.cfg)
        with self.rec.span("weights"):
            self.weights = model.draw_weights(self.cfg, self.ctx.seed,
                                              self.ctx.device)
        model.check_layout(self.cfg, self.weights)
        self.prefill = step.make_prefill_step(self.pcfg)
        spec = self.mix["prompt_len"]
        self.lens = traffic.lengths(spec, int(spec["count"]))
        srt = np.sort(self.lens)
        n = int(self.mix["warm"])
        gen = traffic.rng(self.ctx.seed, 3)
        with self.rec.span("warm"):
            for i in np.linspace(0, len(srt) - 1, n).round().astype(int):
                self.first_token(traffic.tokens(gen, (int(srt[i]),),
                                                self.cfg["vocab_size"]))

    def first_token(self, prompt: np.ndarray):
        tok = torch.as_tensor(prompt, device=self.ctx.device)[None]
        logits, cache = self.prefill(self.weights, {"tokens": tok})
        first = int(torch.argmax(logits, -1).cpu()[0])
        del cache
        return first, logits

    def run_window(self, seconds: float) -> None:
        rec = self.rec
        win = window.Window(seconds)
        for k in win:
            gen = traffic.rng(self.ctx.seed, 1, k)
            for n in self.lens[gen.permutation(len(self.lens))]:
                prompt = traffic.tokens(gen, (int(n),),
                                        self.cfg["vocab_size"])
                with rec.span("request"):
                    a = time.perf_counter()
                    _, logits = self.first_token(prompt)
                    ttft = time.perf_counter() - a
                self.requests.append((prompt, ttft, logits.float().cpu()))
                rec.add("attempted", 1)
        rec.info["cfg"] = self.cfg
        rec.info["requests"] = [(len(p), t) for p, t, _ in self.requests]
        rec.info["units_s"] = win.units_s

    def end_to_end(self) -> dict:
        ttft = np.array([t for _, t, _ in self.requests])
        self.rec.counters["requests"] = len(ttft)
        return {"ttft_p90_ms": float(np.percentile(ttft, 90)) * 1e3}

    def release(self) -> None:
        """Nothing to free: each request's cache died with the request."""

    def sample(self) -> list:
        idx = list(range(len(self.requests)))
        longest = max(idx, key=lambda i: len(self.requests[i][0]))
        rest = [i for i in idx if i != longest]
        n = min(len(rest), int(self.mix["sample_requests"]) - 1)
        pick = traffic.rng(self.ctx.seed, 2).choice(len(rest), n,
                                                    replace=False)
        return [longest] + [rest[j] for j in sorted(pick)]

    def check(self, control: bool = False) -> list:
        dev = self.ctx.device
        picked = [self.requests[i] for i in self.sample()]
        seqs = [torch.as_tensor(p, device=dev) for p, _, _ in picked]
        rows = [torch.tensor([len(p) - 1], device=dev) for p, _, _ in picked]

        def err(refs, got):
            return max(float((g.to(dev) - r).abs().max()
                             / r.square().mean().sqrt())
                       for r, g in zip(refs, got))
        ref = dense_lm.logits(self.cfg, self.weights, seqs, rows)
        out = {"name": "prefill_logit_err",
               "value": err(ref, [lg for _, _, lg in picked]),
               "limit": float(self.mix["limits"]["prefill_logit_err"])}
        if control:
            low = dense_lm.logits(self.cfg, self.weights, seqs, rows,
                                  dense_lm.Precision("fp8"))
            out["control"] = err(ref, low)
        return [out]
