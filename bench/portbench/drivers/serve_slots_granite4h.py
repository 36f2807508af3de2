"""Slot-streamed decode of Granite-4.0-H-Small: ``serve_slots``'s
closed-loop client, window and check, with this configuration's weights
(``portbench.granite4h``) and plain reference
(``reference.granite_moe_hybrid``).

The family keeps recurrent state, so the slot engine prefills each
request at its own length and admits its KV slice and its Mamba-2 row
together.

The check: a seeded sample of the window's requests, the longest prompt
among them, is run once through the f32 reference over the prompt and its
served tokens; the number compared is the widest gap by which a served
token's logit lies below the reference's best at its position.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import granite4h, traffic
from portbench.drivers import serve_slots
from reference import granite_moe_hybrid


class Driver(serve_slots.Driver):
    def setup(self) -> None:
        from repro_torch.launch import serve

        self.serve = serve
        self.pcfg = granite4h.port_config(self.cfg)
        with self.rec.span("weights"):
            self.weights = granite4h.draw_weights(self.cfg, self.ctx.seed,
                                                  self.ctx.device)
        granite4h.check_layout(self.cfg, self.weights)
        self.lens = traffic.lengths(self.mix["prompt_len"],
                                    self.mix["requests_per_call"])
        self.s0 = int(self.lens.max())
        self.max_new = int(self.mix["max_new"])
        self.horizon = self.s0 + self.max_new
        # the window's shapes: the exact-length prefills of a call's
        # prompts, the admission and the (slots, horizon) decode step
        with self.rec.span("warm"):
            prompts, lens = self.call_inputs(traffic.rng(self.ctx.seed, 0))
            self.generate(prompts[:1], lens[:1], max_new=2)

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
        ref = granite_moe_hybrid.logits(self.cfg, self.weights, seqs, rows)
        gap = max(float((r.max(-1).values
                         - r.gather(-1, s[:, None])[:, 0]).max())
                  for r, s in zip(ref, served))
        out = {"name": "decode_gap", "value": gap,
               "limit": float(self.mix["limits"]["decode_gap"])}
        if control:
            # the reference in float8 in the program's place: the gap of
            # the token it puts first
            low = granite_moe_hybrid.logits(
                self.cfg, self.weights, seqs, rows,
                granite_moe_hybrid.Precision("fp8"))
            out["control"] = max(
                float((r.max(-1).values
                       - r.gather(-1, q.argmax(-1, keepdim=True))[:, 0])
                      .max()) for r, q in zip(ref, low))
        return [out]
