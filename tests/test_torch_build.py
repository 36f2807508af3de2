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
            == ["compact_pack.cu"]
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
