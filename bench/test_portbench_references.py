"""Each plain reference against the program at a smoke size on the host:
the dense decoder's logits, the shard format and the bin-pack plan."""

import numpy as np
import pytest
import torch

from portbench import model
from reference import dense_lm, shards as ref_shards

SMOKE = {"name": "smoke", "num_hidden_layers": 2, "hidden_size": 64,
         "intermediate_size": 96, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 300,
         "tie_word_embeddings": True, "rope_theta": 10000.0,
         "rms_norm_eps": 1e-5, "init": {"embed_std": 0.5}}

def f32(tree):
    return {k: f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def weights():
    w = model.draw_weights(SMOKE, 3, torch.device("cpu"))
    model.check_layout(SMOKE, w)
    return w


def test_logits_match_the_port_in_f32(weights):
    from repro_torch.models import transformer

    pcfg = model.port_config(SMOKE)
    tok = torch.randint(0, 300, (2, 40), generator=torch.Generator()
                        .manual_seed(0))
    got = transformer.forward(pcfg, f32(weights), {"tokens": tok},
                              "encode")[0]
    want = dense_lm.logits(SMOKE, weights, list(tok),
                           [torch.arange(40)] * 2)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, atol=1e-4, rtol=1e-4)


def test_fp8_control_departs(weights):
    tok = torch.randint(0, 300, (40,), generator=torch.Generator()
                        .manual_seed(1))
    a = dense_lm.logits(SMOKE, weights, [tok], [torch.arange(40)])[0]
    b = dense_lm.logits(SMOKE, weights, [tok], [torch.arange(40)],
                        dense_lm.Precision("fp8"))[0]
    err = float((a - b).abs().max() / a.square().mean().sqrt())
    assert 1e-3 < err < 1.0


def test_shard_decoder_reads_the_port_format():
    from repro_torch.data import shards

    toks = np.random.default_rng(0).integers(0, 49155, 3001, dtype=np.int32)
    raw = shards.encode_shard(toks)
    assert (ref_shards.decode(raw) == toks).all()
    assert len(raw) == ref_shards.encoded_size(3001)


def test_plan_matches_the_port_binpack():
    from repro_torch.lst.compaction import plan_binpack
    from repro_torch.lst.files import DataFile

    rng = np.random.default_rng(5)
    sizes = rng.choice([100, 250, 400, 700, 1000], size=40)
    files = [DataFile(f"f{i}", int(s), 1) for i, s in enumerate(sizes)]
    got = [[f.path for f in t.inputs] for t in plan_binpack(files, 1000)]
    want = ref_shards.plan_bins([(f.path, f.size_bytes) for f in files],
                                1000)
    assert got == want
