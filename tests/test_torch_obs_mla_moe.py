"""The spans and counters of the latent-attention MoE family
(``models/moe.py::dropless_moe_apply``, ``models/attention.py::mla_apply``)
on DeepSeek-V2-Lite's smoke config: the spans of an eager prefill, the
counters against the shapes worked by hand, and, on the card (each card
test skips without one), the decode step captured as a CUDA graph with no
sync inside it, its counters counted once at the capture, and the
prefill's routed experts captured likewise.

On the card, from the repo root (the suite's conftest imports JAX)::

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_obs_mla_moe.py -k card
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import smoke_config
from repro_torch.launch import serve
from repro_torch.models import moe, registry, transformer
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train import step as step_lib

SPANS = ("moe.route", "moe.experts", "moe.shared", "mla.expand")


@pytest.fixture
def recorder():
    obs.clear()
    obs.enable()
    yield
    obs.disable()
    obs.clear()


def _model(dev="cpu", seed=4):
    cfg = smoke_config("deepseek-v2-lite")
    return cfg, transformer.init_params(cfg, seed=seed, device=dev)


def test_eager_prefill_records_each_span(recorder):
    """One span of each name per layer that has it: ``mla.expand`` in all
    3 layers, the MoE spans in the 2 MoE layers."""
    cfg, params = _model()
    tok = torch.randint(0, cfg.vocab, (2, 11))
    step_lib.make_prefill_step(cfg)(params, {"tokens": tok})
    names = [s.name for s in obs.spans()]
    n_moe = cfg.n_layers - cfg.first_dense
    assert {n: names.count(n) for n in SPANS} == {
        "moe.route": n_moe, "moe.experts": n_moe, "moe.shared": n_moe,
        "mla.expand": cfg.n_layers}
    assert all(s.end is not None and s.end >= s.start for s in obs.spans())


def test_counters_match_the_shapes(recorder):
    """Prefill of 2 x 11 tokens, then one decode step of 2 rows over a
    cache of 16 positions; 2 MoE layers of 8 experts, top 3. Prefill
    computes only the routed rows (2 x 11 x 3 a layer); decode computes
    every expert on every row (2 x 8). Decode reads the bf16 latent (16)
    and rope (8) cache and builds K (4 heads x (8 + 8)) and V (4 x 16) in
    bf16, in each of the 3 layers."""
    cfg, params = _model()
    tok = torch.randint(0, cfg.vocab, (2, 11))
    _, cache = step_lib.make_prefill_step(cfg)(params, {"tokens": tok})
    c = obs.counters()
    assert c["moe.prefill.rows_needed"] == 2 * 2 * 11 * 3
    assert c["moe.prefill.rows_computed"] == 2 * 2 * 11 * 3
    assert "mla.decode.latent_bytes" not in c
    obs.clear()
    total = 16
    cache = serve.grow_cache(cache, transformer.abstract_cache(cfg, 2, total))
    step_lib.make_decode_step(cfg, total)(params, cache, {
        "tokens": tok[:, :1], "pos": torch.tensor([11, 11])})
    c = obs.counters()
    assert c["moe.decode.rows_needed"] == 2 * 2 * 3
    assert c["moe.decode.rows_computed"] == 2 * 2 * 8
    assert c["mla.decode.latent_bytes"] == 3 * 2 * total * (16 + 8) * 2
    assert c["mla.decode.kv_bytes"] == 3 * 2 * total * 4 * (16 + 16) * 2
    assert not any(k.startswith("moe.prefill") for k in c)


def test_recording_off_counts_nothing():
    obs.clear()
    cfg, params = _model()
    step_lib.make_prefill_step(cfg)(params, {"tokens": torch.zeros(
        (1, 5), dtype=torch.int64)})
    assert obs.counters() == {} and obs.spans() == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph is captured only there")
    return torch.device("cuda", 0)


def test_card_captured_step_has_no_sync(card, recorder):
    """The decode step captured as a CUDA graph: a host sync inside it
    (an ``.item()``, a ``.tolist()``, a data-dependent shape) is an error
    under capture, so the capture's success shows there is none. Each
    replay's logits equal the eager step's bit for bit, and the counters
    hold two passes (the eager first step and the capture), none a
    replay."""
    cfg, params = _model(card)
    n, total, steps = 4, 24, 5
    decode = step_lib.make_decode_step(cfg, total)
    store = registry.state_store(cfg, n, total)
    start = store.init_state(card)
    gen = torch.Generator(device=card).manual_seed(7)
    for leaf in tree_leaves(start):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=card)
                   .mul_(0.5).to(leaf.dtype))
    eager = serve._SlotStep(decode, params, tree_map(torch.clone, start),
                            n, card, "static")
    graphed = serve._SlotStep(decode, params, tree_map(torch.clone, start),
                              n, card, "graph")
    tok = np.array([3, 9, 0, 14], np.int32)
    pos = np.array([3, 9, 0, 14], np.int32)
    want = [eager(tok, pos + i).clone() for i in range(steps)]
    obs.clear()
    got = [graphed(tok, pos + i).clone() for i in range(steps)]
    assert graphed.replays == steps - 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    c = obs.counters()
    n_moe = cfg.n_layers - cfg.first_dense
    assert c["moe.decode.rows_computed"] == 2 * n_moe * n * cfg.n_experts
    assert c["serve.graph.captures"] == 1


def test_card_grouped_experts_have_no_sync(card):
    """The prefill's MoE layer (the router, the pairs sorted by expert,
    the segments counted on the card, the grouped GEMMs, the shared
    experts) captured as a CUDA graph in bf16, the served dtype: the
    capture fails on any host sync, as ``torch.bincount``'s on CUDA. The
    replay equals the eager pass bit for bit."""
    cfg, params = _model(card)
    p = tree_map(lambda t: t[0].to(torch.bfloat16), params["layers"]["moe"])
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn((2, 37, cfg.d_model), generator=gen, device=card
                    ).to(torch.bfloat16)
    want = moe.dropless_moe_apply(cfg, p, x, "prefill")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = moe.dropless_moe_apply(cfg, p, x, "prefill")
    graph.replay()
    torch.cuda.synchronize(card)
    assert torch.equal(got, want)
