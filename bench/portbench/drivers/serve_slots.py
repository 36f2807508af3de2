"""Slot-streamed decode: one client in a closed loop hands the port's
serving entry ``launch.serve.generate(..., stream="slots")`` a call of
requests at a time, greedy; the window runs whole calls, each started only
where it would end inside the window (``portbench.window``).

Mix keys: ``requests_per_call``, ``slots``, ``prompt_len`` (a
``traffic.lengths`` spec), ``max_new`` (new tokens of every request of a
call: ``generate`` takes one per call), ``sample_requests`` (the check's
sample) and ``limits``.

The check: a seeded sample of the window's requests, the longest prompt
among them, is run once through the plain f32 reference over the prompt
and its served tokens; the number compared is the widest gap by which a
served token's logit lies below the reference's best at its position.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import model, traffic, window
from reference import dense_lm


class Driver:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.cfg, self.mix, self.rec = ctx.cfg, ctx.mix, ctx.rec
        self.calls = []

    def setup(self) -> None:
        from repro_torch.launch import serve

        self.serve = serve
        self.pcfg = model.port_config(self.cfg)
        with self.rec.span("weights"):
            self.weights = model.draw_weights(self.cfg, self.ctx.seed,
                                              self.ctx.device)
        model.check_layout(self.cfg, self.weights)
        self.lens = traffic.lengths(self.mix["prompt_len"],
                                    self.mix["requests_per_call"])
        self.s0 = int(self.lens.max())
        self.max_new = int(self.mix["max_new"])
        self.horizon = self.s0 + self.max_new
        # the window's shapes: a (1, s0) prefill, the admission and the
        # (slots, horizon) decode step
        with self.rec.span("warm"):
            prompts, lens = self.call_inputs(traffic.rng(self.ctx.seed, 0))
            self.generate(prompts[:1], lens[:1], max_new=2)

    def call_inputs(self, gen):
        lens = self.lens[gen.permutation(len(self.lens))]
        prompts = traffic.tokens(gen, (len(lens), self.s0),
                                 self.cfg["vocab_size"])
        prompts[np.arange(self.s0)[None, :] >= lens[:, None]] = 0
        return prompts, lens

    def generate(self, prompts, lens, max_new):
        return self.serve.generate(
            self.pcfg, self.weights, prompts, max_new=max_new,
            prompt_lens=lens, stream="slots", slots=int(self.mix["slots"]),
            horizon=self.horizon)

    def run_window(self, seconds: float) -> None:
        rec = self.rec
        win = window.Window(seconds)
        for k in win:
            prompts, lens = self.call_inputs(traffic.rng(self.ctx.seed, 1, k))
            with rec.span("generate"):
                out = self.generate(prompts, lens, self.max_new)
            stats = self.serve._generate_slots.last_stats
            rec.add("decode_steps", stats["decode_steps"])
            rec.add("generated", out.size)
            rec.add("attempted", len(lens))
            rec.add("failed", int((out.shape[1] != self.max_new)
                                  * len(lens)))
            self.calls.append((prompts, lens, out))
        self.elapsed = win.elapsed
        rec.info["units_s"] = win.units_s
        rec.info["cfg"] = self.cfg
        rec.info["requests"] = [(int(n), self.max_new)
                                for _, lens, _ in self.calls for n in lens]

    def end_to_end(self) -> dict:
        return {"serve_tok_s": self.rec.counters["generated"]
                / self.elapsed}

    def release(self) -> None:
        """Nothing to free: ``generate`` keeps no state between calls;
        the weights are the benchmark's input, which the check reads."""

    def sample(self):
        """The checked requests: the longest prompt, then a seeded draw."""
        rows = [(c, i) for c, (_, lens, _) in enumerate(self.calls)
                for i in range(len(lens))]
        longest = max(rows, key=lambda r: self.calls[r[0]][1][r[1]])
        rest = [r for r in rows if r != longest]
        n = min(len(rest), int(self.mix["sample_requests"]) - 1)
        pick = traffic.rng(self.ctx.seed, 2).choice(len(rest), n,
                                                    replace=False)
        return [longest] + [rest[j] for j in sorted(pick)]

    def check(self, control: bool = False) -> list:
        dev = self.ctx.device
        seqs, rows, served = [], [], []
        for c, i in self.sample():
            prompts, lens, out = self.calls[c]
            n = int(lens[i])
            seq = np.concatenate([prompts[i, :n], out[i, :-1]])
            seqs.append(torch.as_tensor(seq, device=dev))
            rows.append(torch.arange(n - 1, n - 1 + out.shape[1], device=dev))
            served.append(torch.as_tensor(out[i], device=dev).long())
        ref = dense_lm.logits(self.cfg, self.weights, seqs, rows)
        gap = max(float((r.max(-1).values
                         - r.gather(-1, s[:, None])[:, 0]).max())
                  for r, s in zip(ref, served))
        out = {"name": "decode_gap", "value": gap,
               "limit": float(self.mix["limits"]["decode_gap"])}
        if control:
            low = dense_lm.logits(self.cfg, self.weights, seqs, rows,
                                  dense_lm.Precision("fp8"))
            out["control"] = max(
                float((r.max(-1).values
                       - r.gather(-1, q.argmax(-1, keepdim=True))[:, 0])
                      .max()) for r, q in zip(ref, low))
        return [out]
