"""The port's tunable-op registry (repro_torch.kernels.api / tuned).

``fit_block`` keeps the JAX package's table, ``register`` rejects a bad
default, dispatch resolves explicit point > tuned cache > default and
clamps, and the tuned cache round-trips in its own directory, where a
point written for another device kind is a clean miss.
"""

import json

import numpy as np
import pytest
import torch

from repro.kernels import api as japi
from repro_torch.kernels import api, tuned


@pytest.fixture()
def tuned_dir(tmp_path, monkeypatch):
    """Point the port's tuned-point cache at a throwaway dir."""
    monkeypatch.setenv("REPRO_TORCH_TUNED_DIR", str(tmp_path))
    tuned.invalidate_memo()
    yield tmp_path
    tuned.invalidate_memo()


class TestFitBlock:
    @pytest.mark.parametrize("value,extent,expect", [
        (512, 256, 256),      # clamp to extent
        (512, 512, 512),      # exact fit
        (128, 512, 128),      # already a divisor
        (512, 100, 100),      # clamp, divides
        (96, 256, 32),        # 256 % 96 != 0 -> gcd
        (256, 300, 4),        # gcd fallback on awkward extents
        (7, 512, 1),          # coprime -> 1, never asserts
        (512, 0, 512),        # degenerate extent: leave value alone
    ])
    def test_table(self, value, extent, expect):
        got = api.fit_block(value, extent)
        assert got == expect == japi.fit_block(value, extent)
        if extent > 0:
            assert extent % got == 0


class TestRegistry:
    def test_builtin_ops_registered(self):
        assert set(api.ops()) == {"compact_pack"}

    def test_register_rejects_default_outside_candidates(self):
        bad = api.TunableOp(
            name="bad", axes={"b": (1, 2)}, default={"b": 3},
            run=lambda p: None, ref=lambda: None,
            clamp=lambda p: p, shape_key=lambda: "x",
            example=lambda q: ((), {}))
        with pytest.raises(ValueError):
            api.register(bad)

    def test_register_rejects_axis_without_default(self):
        bad = api.TunableOp(
            name="bad", axes={"b": (1, 2)}, default={},
            run=lambda p: None, ref=lambda: None,
            clamp=lambda p: p, shape_key=lambda: "x",
            example=lambda q: ((), {}))
        with pytest.raises(ValueError):
            api.register(bad)

    def test_clamped_axes_dedupe_on_short_plan(self):
        op = api.get_op("compact_pack")
        src = torch.zeros(4 * 1024, dtype=torch.int32)
        cm = np.arange(4, dtype=np.int32)
        assert api.clamped_axes(op, src, cm) == {"block_chunks": (1, 2, 4)}

    def test_every_grid_point_matches_ref(self):
        op = api.get_op("compact_pack")
        args, kwargs = op.example(True)
        ref = op.ref(*args, **kwargs)
        for g in api.clamped_axes(op, *args, **kwargs)["block_chunks"]:
            out = op.run(op.clamp({"block_chunks": g}, *args, **kwargs),
                         *args, **kwargs)
            assert torch.equal(out, ref), g

    def test_shape_key_names_dtype_like_jax(self):
        op = api.get_op("compact_pack")
        src = torch.zeros(3 * 1024, dtype=torch.int32)
        cm = np.arange(3, dtype=np.int32)
        assert op.shape_key(src, cm) == "nsrc3_nout3:int32"
        assert op.shape_key(src, cm, keep_mask=np.ones(24, bool)) \
            == "nsrc3_nout3:int32_filter"


class TestTunedCache:
    def test_cache_lives_in_its_own_directory(self, monkeypatch):
        monkeypatch.delenv("REPRO_TORCH_TUNED_DIR", raising=False)
        assert tuned.cache_dir().parts[-2:] == ("experiments", "tuned_torch")

    def test_round_trip(self, tuned_dir):
        tuned.store("compact_pack", "nsrc64_nout64:int32",
                    {"block_chunks": 8}, objective_us=10.5, evaluations=5)
        assert (tuned_dir / "kernel_points.json").exists()
        assert tuned.lookup("compact_pack", "nsrc64_nout64:int32") \
            == {"block_chunks": 8}
        rec = tuned.entry("compact_pack", "nsrc64_nout64:int32")
        assert rec["objective_us"] == pytest.approx(10.5)
        assert rec["evaluations"] == 5
        assert rec["device_kind"] == tuned.device_kind()
        assert tuned.lookup("compact_pack", "nsrc1_nout1:int32") is None

    def test_stale_device_kind_is_clean_miss(self, tuned_dir):
        key = "nsrc128_nout128:int32"
        (tuned_dir / "kernel_points.json").write_text(json.dumps({
            "version": 1, "points": {f"compact_pack|{key}": {
                "device_kind": "some other card",
                "point": {"block_chunks": 16},
                "objective_us": 1.0, "evaluations": 1}}}))
        tuned.invalidate_memo()
        assert tuned.lookup("compact_pack", key) is None
        op = api.get_op("compact_pack")
        args, kwargs = op.example(True)
        assert api.resolve_point(op, *args, **kwargs) == {"block_chunks": 1}

    def test_corrupt_file_is_clean_miss(self, tuned_dir):
        (tuned_dir / "kernel_points.json").write_text("{not json")
        tuned.invalidate_memo()
        assert tuned.lookup("compact_pack", "x") is None

    def test_tuned_point_serves_then_clamps(self, tuned_dir):
        """A cached point for this device kind is picked up at call time,
        and a cached point too large for the plan clamps instead of
        failing; the output never changes (an exact axis)."""
        op = api.get_op("compact_pack")
        args, kwargs = op.example(True)
        tuned.store("compact_pack", op.shape_key(*args, **kwargs),
                    {"block_chunks": 16}, objective_us=1.0, evaluations=1)
        assert api.resolve_point(op, *args, **kwargs) == {"block_chunks": 16}
        out = api.call("compact_pack", *args, **kwargs)
        assert torch.equal(out, op.ref(*args, **kwargs))
        short = (args[0][:4 * 1024], np.arange(4, dtype=np.int32))
        tuned.store("compact_pack", op.shape_key(*short),
                    {"block_chunks": 16}, objective_us=1.0, evaluations=1)
        point = op.clamp(api.resolve_point(op, *short), *short)
        assert point == {"block_chunks": 4}
        assert torch.equal(api.call("compact_pack", *short),
                           op.ref(*short))
