"""The spans and counters of the Mamba-2 mixer
(``models/ssm.py::mamba2_apply``) on Granite-4.0-H-Small's smoke config:
the spans of an eager prefill and an eager decode step, the counters
against the shapes worked by hand, and, on the card (the card test skips
without one), the decode step captured as a CUDA graph with no sync
inside it, its counters counted once at the capture.

On the card, from the repo root (the suite's conftest imports JAX)::

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_obs_hybrid_moe.py -k card
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import smoke_config
from repro_torch.launch import serve
from repro_torch.models import registry, transformer
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train import step as step_lib


@pytest.fixture
def recorder():
    obs.clear()
    obs.enable()
    yield
    obs.disable()
    obs.clear()


def _model(dev="cpu", seed=4):
    cfg = smoke_config("granite-4.0-h-small")
    return cfg, transformer.init_params(cfg, seed=seed, device=dev)


def _prefill(cfg, params, b=2, s=11):
    tok = torch.randint(0, cfg.vocab, (b, s),
                        generator=torch.Generator().manual_seed(1))
    return tok, step_lib.make_prefill_step(cfg)(params, {"tokens": tok})


def test_eager_passes_record_each_span(recorder):
    """Prefill: ``ssm.conv`` and ``ssm.scan`` in each of the 4 Mamba-2
    layers, the MoE spans in all 6 layers, no ``ssm.update``. A decode
    step: ``ssm.conv`` and ``ssm.update`` in each Mamba-2 layer."""
    cfg, params = _model()
    tok, (_, cache) = _prefill(cfg, params)
    names = [s.name for s in obs.spans()]
    count = {n: names.count(n) for n in ("ssm.conv", "ssm.scan",
                                         "ssm.update", "moe.route",
                                         "moe.experts", "moe.shared")}
    assert count == {"ssm.conv": 4, "ssm.scan": 4, "ssm.update": 0,
                     "moe.route": 6, "moe.experts": 6, "moe.shared": 6}
    assert all(s.end is not None and s.end >= s.start for s in obs.spans())
    obs.clear()
    cache = serve.grow_cache(cache, transformer.abstract_cache(cfg, 2, 16))
    step_lib.make_decode_step(cfg, 16)(params, cache, {
        "tokens": tok[:, :1], "pos": torch.tensor([11, 11])})
    names = [s.name for s in obs.spans()]
    assert (names.count("ssm.conv"), names.count("ssm.update"),
            names.count("ssm.scan")) == (4, 4, 0)


def test_counters_match_the_shapes(recorder):
    """4 Mamba-2 layers, 2 rows; a row's state is 8 heads x 16 x 16 and
    its conv tail 3 x 160 (inner 128 plus B and C of 16), bf16. Prefill
    hands that state to the cache; decode reads it, and its update makes
    an f32 copy of the state (4 bytes an element) and the bf16 new state
    (2). The MoE counters count this family as DeepSeek's: 6 layers of 8
    experts, top 3."""
    cfg, params = _model()
    state, conv = 8 * 16 * 16, 3 * 160
    tok, (_, cache) = _prefill(cfg, params)
    c = obs.counters()
    assert c["ssm.prefill.state_bytes"] == 4 * 2 * (state + conv) * 2
    assert c["moe.prefill.rows_needed"] == 6 * 2 * 11 * 3
    assert "ssm.decode.work_bytes" not in c
    obs.clear()
    cache = serve.grow_cache(cache, transformer.abstract_cache(cfg, 2, 16))
    step_lib.make_decode_step(cfg, 16)(params, cache, {
        "tokens": tok[:, :1], "pos": torch.tensor([11, 11])})
    c = obs.counters()
    assert c["ssm.decode.state_bytes"] == 4 * 2 * (state + conv) * 2
    assert c["ssm.decode.work_bytes"] == 4 * 2 * state * (4 + 2)
    assert c["moe.decode.rows_needed"] == 6 * 2 * 3
    assert c["moe.decode.rows_computed"] == 6 * 2 * 8
    assert not any(k.startswith(("ssm.prefill", "moe.prefill")) for k in c)


def test_recording_off_counts_nothing():
    obs.clear()
    cfg, params = _model()
    _prefill(cfg, params, b=1, s=5)
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
    replay's logits and state table equal the eager step's bit for bit,
    and the counters hold two passes (the eager first step and the
    capture), none a replay."""
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
    assert all(torch.equal(g, w) for g, w in zip(
        tree_leaves(graphed.cache), tree_leaves(eager.cache)))
    c = obs.counters()
    assert c["ssm.decode.work_bytes"] == 2 * 4 * n * 8 * 16 * 16 * 6
    assert c["serve.graph.captures"] == 1
