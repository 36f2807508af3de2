"""The port's kernel build and the wrappers' operand checks, on the CPU.

There is no ``nvcc`` here, so the build is driven with a stand-in
compiler that writes its ``-o`` file: the library is built at first use,
reused while the source is unchanged, and rebuilt when the source's hash
changes. The wrappers' operand checks are device-agnostic and run on CPU
tensors; a tensor on a device with no kernel is refused.
"""

import os
import stat

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.compact_pack import compact_pack as kern
from repro_torch.kernels.decode_attn import decode_attn as dkern
from repro_torch.kernels.flash_attn import flash_attn as fkern
from repro_torch.kernels.rmsnorm.rmsnorm import check_operands as rms_check
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_kernel


@pytest.fixture()
def fake_build(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// v1\n")
    log = tmp_path / "calls.log"
    cc = tmp_path / "nvcc"
    cc.write_text("#!/bin/sh\n"
                  f"echo \"$@\" >> {log}\n"
                  "while [ $# -gt 1 ]; do\n"
                  "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi\n"
                  "  shift\n"
                  "done\n")
    cc.chmod(cc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "_CSRC", csrc)
    monkeypatch.setattr(build, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc", lambda: str(cc))
    return csrc, log


def _calls(log):
    return log.read_text().splitlines() if log.exists() else []


class TestBuild:
    def test_builds_once_then_reuses(self, fake_build):
        _, log = fake_build
        lib = build.build("k")
        assert lib.read_text() == "lib\n"
        assert build.build("k") == lib
        calls = _calls(log)
        assert len(calls) == 1
        assert "arch=compute_90a,code=sm_90a" in calls[0]
        assert "-shared" in calls[0].split()

    def test_source_change_rebuilds(self, fake_build):
        csrc, log = fake_build
        build.build("k")
        (csrc / "k.cu").write_text("// v2\n")
        build.build("k")
        assert len(_calls(log)) == 2

    def test_build_all_covers_every_source(self, fake_build):
        csrc, log = fake_build
        (csrc / "j.cu").write_text("// j\n")
        libs = build.build_all()
        assert sorted(libs) == ["j", "k"]
        assert all(p.exists() for p in libs.values())
        assert len(_calls(log)) == 2

    def test_compiler_failure_raises(self, fake_build, tmp_path,
                                     monkeypatch):
        bad = tmp_path / "bad_nvcc"
        bad.write_text("#!/bin/sh\necho 'error: nope' >&2\nexit 2\n")
        bad.chmod(bad.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setattr(build, "nvcc", lambda: str(bad))
        with pytest.raises(RuntimeError, match="(?s)nvcc failed.*nope"):
            build.build("k")

    def test_missing_nvcc_is_a_clear_error(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.nvcc()

    def test_real_sources_are_listed(self):
        assert sorted(p.name for p in build._CSRC.glob("*.cu")) \
            == ["compact_pack.cu", "decode_attn.cu", "flash_attn.cu",
                "rmsnorm.cu"]
        assert os.path.basename(build._BUILD_DIR) == "kernels"


class TestOperandChecks:
    def _src(self, n=4):
        return torch.arange(n * 1024, dtype=torch.int32).reshape(n, 8, 128)

    def test_good_operands_pass(self):
        src = self._src()
        kern._check_operands(src, torch.empty_like(src),
                             torch.zeros(4, dtype=torch.int32))

    @pytest.mark.parametrize("bad", ["int64-table", "strided", "misaligned"])
    def test_bad_operands_raise(self, bad):
        src = self._src()
        table = torch.zeros(4, dtype=torch.int32)
        if bad == "int64-table":
            table = table.long()
        elif bad == "strided":
            src = src.transpose(1, 2)
        else:
            src = src.reshape(-1)[1:1 + 3 * 1024].reshape(3, 8, 128)
        with pytest.raises(ValueError):
            kern._check_operands(src, torch.empty(src.shape,
                                                  dtype=src.dtype), table)

    def test_device_without_kernel_is_refused(self):
        src = torch.empty((2, 8, 128), dtype=torch.int32, device="meta")
        cm = torch.zeros(2, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="no kernel for meta"):
            kern.compact_chunks_kernel(src, cm)
        with pytest.raises(ValueError, match="no kernel for meta"):
            kern.compact_filter_kernel(src, cm, cm.repeat(8), cm, 1, 8)

    def test_cpu_filter_places_flush_step_rows(self):
        """The flush step (every row DROP_SLOT) writes nothing; the tail
        of the last output chunk is zero."""
        src = self._src(2) + 1
        chunk_sel = torch.tensor([0, 1, 1], dtype=torch.int32)
        keep = np.tile([True] * 5 + [False] * 3, 2)
        dest = np.full(24, kern.DROP_SLOT, np.int32)
        dest[:16][keep] = np.arange(10)     # carry: step 1 fills 5..9
        out_idx = torch.tensor([0, 0, 1], dtype=torch.int32)
        got = kern.compact_filter_kernel(src, chunk_sel,
                                         torch.from_numpy(dest), out_idx,
                                         2, 10)
        rows = src.reshape(-1, 128)[torch.from_numpy(np.flatnonzero(keep))]
        assert torch.equal(got.reshape(-1, 128)[:10], rows)
        assert not got.reshape(-1, 128)[10:].any()


class TestSweepKernelChecks:
    """The rmsnorm, decode_attn and flash_attn wrappers' operand checks,
    run on CPU tensors; each returns the C entry point's dtype code."""

    def test_dtype_codes_and_launch_errors(self):
        assert build.dtype_code(torch.float32, "k") == 0
        assert build.dtype_code(torch.bfloat16, "k") == 1
        with pytest.raises(ValueError, match="no kernel for float16"):
            build.dtype_code(torch.float16, "k")
        build.raise_on(0, "k")
        with pytest.raises(RuntimeError, match="error 700"):
            build.raise_on(700, "k")

    def test_rmsnorm_checks(self):
        x = torch.zeros(4, 64, dtype=torch.bfloat16)
        sc = torch.ones(64, dtype=torch.bfloat16)
        assert rms_check(x, sc) == 1
        for bad_x, bad_sc in [(x, sc.float()), (x[:, :60], sc[:60]),
                              (x.t(), torch.ones(4, dtype=torch.bfloat16)),
                              (x, torch.ones(32, dtype=torch.bfloat16))]:
            with pytest.raises(ValueError):
                rms_check(bad_x, bad_sc)

    def _decode(self, h=8, hkv=2, d=64, dtype=torch.bfloat16):
        return (torch.zeros(2, h, d, dtype=dtype),
                torch.zeros(2, 16, hkv, d, dtype=dtype),
                torch.zeros(2, 16, hkv, d, dtype=dtype),
                torch.zeros(2, dtype=torch.int32))

    def test_decode_checks(self):
        assert dkern.check_operands(*self._decode()) == 1
        assert dkern.check_operands(*self._decode(d=128,
                                                  dtype=torch.float32)) == 0
        q, k, v, lens = self._decode()
        for bad in [self._decode(d=96), self._decode(h=32, hkv=2),
                    self._decode(h=6, hkv=2),
                    (q, k, v, lens.long()), (q, k, v[:, :8], lens),
                    (q, k.transpose(1, 2), v, lens)]:
            with pytest.raises(ValueError):
                dkern.check_operands(*bad)

    def test_decode_refuses_an_empty_cache(self):
        q = torch.zeros(1, 4, 64, dtype=torch.bfloat16)
        kv = torch.zeros(1, 0, 2, 64, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="must hold a position"):
            dkern.check_operands(q, kv, kv, torch.zeros(1, dtype=torch.int32))

    def test_decode_launch_plan(self):
        """block_k clamps to the cache; one CTA per SM; the partials are
        sized from the shape; a block_k above MAX_BLOCK_K is refused."""
        assert dkern.launch_plan(32768, 1024, 132) == (1024, 132, 32)
        assert dkern.launch_plan(100, 512, 132) == (100, 132, 1)
        assert dkern.launch_plan(32768, 128, 132) == (128, 132, 132)
        assert dkern.launch_plan(8192, dkern.MAX_BLOCK_K, 132)[0] == 1024
        with pytest.raises(ValueError, match="above"):
            dkern.launch_plan(8192, 4096, 132)

    def test_flash_checks(self):
        q = torch.zeros(1, 4, 64, 128, dtype=torch.bfloat16)
        kv = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16)
        assert fkern.check_operands(q, kv, kv, 64, 64) == 1
        for args in [(q, kv, kv, 64, 256), (q, kv, kv, 0, 64),
                     (q[..., :80].contiguous(), kv[..., :80].contiguous(),
                      kv[..., :80].contiguous(), 64, 64),
                     (q, kv.float(), kv, 64, 64),
                     (q.transpose(2, 3), kv, kv, 64, 64)]:
            with pytest.raises(ValueError):
                fkern.check_operands(*args)
        # B * H runs over the grid's second axis, at most 65535 blocks
        wide = torch.zeros(1, 65536, 1, 64, dtype=torch.bfloat16)
        one = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="exceeds the grid"):
            fkern.check_operands(wide, one, one, 1, 32)
        assert fkern.check_operands(wide[:, :65535].contiguous(), one, one,
                                    1, 32) == 1

    def test_devices_without_a_kernel_are_refused(self):
        meta = dict(device="meta", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="no kernel for meta"):
            rmsnorm_kernel(torch.empty(4, 64, **meta),
                           torch.empty(64, **meta))
        with pytest.raises(ValueError, match="no kernel for meta"):
            dkern.decode_attention_kernel(
                torch.empty(1, 4, 64, **meta), torch.empty(1, 8, 2, 64, **meta),
                torch.empty(1, 8, 2, 64, **meta),
                torch.empty(1, dtype=torch.int32, device="meta"))
        with pytest.raises(ValueError, match="no kernel for meta"):
            fkern.flash_attention_kernel(torch.empty(1, 4, 8, 64, **meta),
                                         torch.empty(1, 2, 8, 64, **meta),
                                         torch.empty(1, 2, 8, 64, **meta))
