"""The slot engine's decode step over a table that stays in place
(``launch/serve.py::_SlotStep``), and its CUDA graph.

On the host the step runs eagerly over the static table: its tokens,
positions, cache copy-back and in-place admissions are held to the
reference's greedy tokens (``repro.launch.serve``; JAX is imported inside
the fixture, so that this file runs on the card without it), and the
graph's gate stays shut. On the card (each test skips without one) the
graphed step is held to the eager one bit for bit, in every decoding
family's smoke config, and a call frees its graph when it returns.

On the card, from the repo root (the suite's conftest imports JAX)::

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_serve_graph.py -k card
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import smoke_config
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import registry, transformer
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train import step as step_lib

DECODERS = ("granite-3-8b", "qwen3-moe-30b-a3b", "minicpm3-4b", "hymba-1.5b",
            "internvl2-2b", "xlstm-125m")
LENS = np.array([5, 10, 8, 7], np.int32)


def _prompts(cfg, b, s, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


@pytest.fixture
def recorder():
    obs.clear()
    obs.enable()
    yield
    obs.disable()
    obs.clear()


@pytest.fixture(scope="module")
def models():
    """Per arch: (reference cfg, reference f32 params, port cfg, port
    params), the port's carried from the reference's."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as ref_smoke_config
    from repro.models import transformer as ref_tf
    from repro_torch.models import params_from_jax

    memo = {}

    def get(arch):
        if arch not in memo:
            rcfg = ref_smoke_config(arch)
            p = ref_tf.init_params(rcfg, jax.random.PRNGKey(3))
            p = jax.tree.map(lambda x: x.astype(jnp.float32)
                             if x.dtype == jnp.bfloat16 else x, p)
            cfg = smoke_config(arch)
            memo[arch] = (rcfg, p, cfg, params_from_jax(
                cfg, jax.tree.map(np.asarray, p), device="cpu"))
        return memo[arch]
    return get


# ---------------------------------------------------------------------------
# on the host: the static table against the reference
# ---------------------------------------------------------------------------

STATIC = {
    "dense_int8": ("granite-3-8b", dict(prompt_lens=LENS, slots=2,
                                        cache_transfer="int8",
                                        kv_storage="int8")),
    "dense_f8_int8_act": ("granite-3-8b", dict(prompt_lens=LENS, slots=3,
                                               kv_storage="f8",
                                               act_transport="int8")),
    "ring_buffer": ("hymba-1.5b", dict(prompt_lens=LENS, slots=2,
                                       cache_transfer="int8")),
    "recurrent": ("xlstm-125m", dict(prompt_lens=LENS, slots=2)),
}


@pytest.mark.parametrize("case", sorted(STATIC))
def test_static_table_gives_the_reference_tokens(case, models, recorder):
    """Fewer slots than requests, so admissions land in a table that is
    decoding: the tokens are the reference's, every step ran eagerly and
    nothing was captured."""
    from repro.launch import serve as ref_serve

    arch, kw = STATIC[case]
    rcfg, rp, cfg, tp = models(arch)
    prompts = _prompts(cfg, len(LENS), int(LENS.max()), seed=11)
    want = ref_serve.generate(rcfg, rp, prompts, max_new=6, stream="slots",
                              **kw)
    got = serve.generate(cfg, tp, prompts, max_new=6, stream="slots", **kw)
    assert (got == want).all(), (got, want)
    st = serve._generate_slots.last_stats
    assert st["admissions"] == len(LENS)
    assert st["decode_steps"] == ref_serve._generate_slots.last_stats[
        "decode_steps"]
    assert st["graph_steps"] == 0
    assert obs.counters().get("serve.graph.captures", 0) == 0
    assert obs.counters().get("serve.graph.replays", 0) == 0
    assert not any(s.name == "serve.graph.capture" for s in obs.spans())


@pytest.mark.parametrize("case", ["bf16", "int8_transfer", "int8_storage",
                                  "hymba_int8_transfer"])
def test_row_admission_equals_the_returned_table(case):
    """Admission copies the table ``admit_row`` returns into the static
    table in place: its storage stays, and it equals that table bit for
    bit."""
    arch = "hymba-1.5b" if case.startswith("hymba") else "granite-3-8b"
    transfer = "int8" if "transfer" in case else "bf16"
    storage = "int8" if case == "int8_storage" else "bf16"
    cfg = smoke_config(arch)
    n, total = 3, 12
    store = registry.state_store(cfg, n, total, kv_storage=storage)
    admit = serve.make_slot_admit_step(cfg, n, total, transfer, storage)
    gen = torch.Generator().manual_seed(5)

    def fill(tree):
        for leaf in tree_leaves(tree):
            leaf.copy_(torch.randn(leaf.shape, generator=gen).mul(20)
                       .to(leaf.dtype))
        return tree

    table = fill(store.init_state("cpu"))
    step = serve._SlotStep(None, None, table, n, torch.device("cpu"),
                           "static")
    for slot in (1, 0, 2):
        slc = fill(transformer.zeros_like_spec(store.abstract_row(), "cpu"))
        want = admit(step.cache, slc, slot)
        before = [t.data_ptr() for t in tree_leaves(step.cache)]
        step.admit(admit, slc, slot)
        assert [t.data_ptr() for t in tree_leaves(step.cache)] == before
        for got, w in zip(tree_leaves(step.cache), tree_leaves(want)):
            assert torch.equal(got, w)


@pytest.mark.parametrize("arch", ["granite-3-8b", "hymba-1.5b"])
def test_static_step_equals_rebinding_step(arch):
    """The static table's step (its buffers and the copy-back) gives the logits of the step that rebinds the table, bit for bit, and
    keeps the table's storage."""
    cfg = smoke_config(arch)
    params = transformer.init_params(cfg, seed=2, device="cpu")
    n, total = 3, 16
    decode = step_lib.make_decode_step(cfg, total)
    store = registry.state_store(cfg, n, total)
    cpu = torch.device("cpu")
    static = serve._SlotStep(decode, params, store.init_state(cpu), n, cpu,
                             "static")
    rebind = serve._SlotStep(decode, params, store.init_state(cpu), n, cpu,
                             "rebind")
    ptrs = [t.data_ptr() for t in tree_leaves(static.cache)]
    tok = _prompts(cfg, 1, n, seed=3)[0]
    pos = np.arange(n, dtype=np.int32)
    for _ in range(5):
        a, b = static(tok, pos).clone(), rebind(tok, pos)
        assert torch.equal(a, b)
        tok, pos = serve._greedy(a), pos + 1
    assert [t.data_ptr() for t in tree_leaves(static.cache)] == ptrs
    for x, y in zip(tree_leaves(static.cache), tree_leaves(rebind.cache)):
        assert torch.equal(x, y)
    assert static.replays == 0 and static.cuda_graph is None


def test_gate_is_shut_on_the_host_and_on_ranks():
    from repro_torch.launch import dryrun

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert serve._step_mode(None, cpu) == "static"
    assert serve._step_mode(make_local_mesh(device="cpu"), cpu) == "static"
    assert serve._step_mode(None, cuda) == "graph"
    assert serve._step_mode(make_local_mesh(device="cpu"), cuda) == "graph"
    dryrun.fake_world(4)
    try:
        ranked = make_local_mesh(2, device="cpu")
        assert serve._step_mode(ranked, cuda) == "rebind"
        assert serve._step_mode(ranked, cpu) == "rebind"
    finally:
        dryrun.leave_fake_world()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph is captured only there")
    return torch.device("cuda", 0)


def _card_model(arch, dev):
    cfg = smoke_config(arch)
    return cfg, transformer.init_params(cfg, seed=4, device=dev)


CARD_CASES = [(a, "bf16", "bf16") for a in DECODERS] + [
    ("granite-3-8b", "int8", "bf16"), ("granite-3-8b", "f8", "bf16"),
    ("granite-3-8b", "bf16", "int8"), ("minicpm3-4b", "int8", "int8")]


@pytest.mark.parametrize("arch,storage,act", CARD_CASES)
def test_card_graphed_logits_equal_eager(arch, storage, act, card):
    """Step by step, the replayed graph's logits equal the eager step's
    bit for bit, from the same table and the same tokens and positions,
    and so do the tables after the last step."""
    cfg, params = _card_model(arch, card)
    n, total, steps = 4, 24, 6
    decode = step_lib.make_decode_step(cfg, total, act, storage)
    store = registry.state_store(cfg, n, total, kv_storage=storage)
    start = store.init_state(card)
    gen = torch.Generator(device=card).manual_seed(7)
    for leaf in tree_leaves(start):
        if leaf.dtype.is_floating_point:
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device=card)
                       .mul_(0.5).to(leaf.dtype))
    eager = serve._SlotStep(decode, params, tree_map(torch.clone, start),
                            n, card, "static")
    graphed = serve._SlotStep(decode, params, tree_map(torch.clone, start),
                              n, card, "graph")
    tok = _prompts(cfg, 1, n, seed=9)[0]
    pos = np.array([3, 9, 0, 14], np.int32)
    for i in range(steps):
        want = eager(tok, pos).clone()
        got = graphed(tok, pos).clone()
        assert torch.equal(got, want), (i, (got - want).abs().max().item())
        tok, pos = serve._greedy(want), pos + 1
    assert graphed.replays == steps - 1 and eager.replays == 0
    for x, y in zip(tree_leaves(graphed.cache), tree_leaves(eager.cache)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(kv_storage="int8", cache_transfer="int8"),
    dict(temperature=0.8, seed=3),
], ids=["greedy", "int8", "sampled"])
def test_card_generate_replays_and_frees(kw, card, recorder, monkeypatch):
    """A call with fewer slots than requests (admissions into the graphed
    table): the tokens are the eager step's, every decode step but the
    first replays the graph, one capture, and the card's allocated memory
    is what it was before the call."""
    cfg, params = _card_model("granite-3-8b", card)
    prompts = _prompts(cfg, len(LENS), int(LENS.max()), seed=13)
    args = dict(max_new=7, prompt_lens=LENS, stream="slots", slots=2, **kw)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    got = serve.generate(cfg, params, prompts, **args)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(card) == before
    st = dict(serve._generate_slots.last_stats)
    assert st["graph_steps"] == st["decode_steps"] - 1 > 0
    assert obs.counters()["serve.graph.replays"] == st["graph_steps"]
    assert obs.counters()["serve.graph.captures"] == 1
    assert sum(s.name == "serve.graph.capture" for s in obs.spans()) == 1
    monkeypatch.setattr(serve, "_step_mode", lambda mesh, dev: "static")
    want = serve.generate(cfg, params, prompts, **args)
    assert serve._generate_slots.last_stats["graph_steps"] == 0
    assert serve._generate_slots.last_stats["decode_steps"] \
        == st["decode_steps"]
    assert (got == want).all(), (got, want)


def test_card_one_step_call_captures_nothing(card, recorder):
    """A call of one decode step (the benchmark's warm-up) runs it eagerly
    and captures no graph."""
    cfg, params = _card_model("granite-3-8b", card)
    serve.generate(cfg, params, _prompts(cfg, 1, 6), max_new=2,
                   stream="slots")
    assert serve._generate_slots.last_stats["decode_steps"] == 1
    assert serve._generate_slots.last_stats["graph_steps"] == 0
    assert obs.counters().get("serve.graph.captures", 0) == 0
