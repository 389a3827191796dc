"""bench.py protocol: one JSON line naming the device, measured in-process;
the peak table and the device-only cache are keyed by device kind."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from metagenomic_deepfri_tpu import bench_utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestWatchdogEndToEnd:
    def test_inner_mode_prints_json(self):
        """`bench.py` on CPU with a tiny env-shrunk workload prints one JSON
        record that names the device and says the CPU has no peak."""
        env = dict(os.environ, JAX_PLATFORMS="cpu", MDEEPFRI_BENCH_TINY="1")
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "bench.py")],
            capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
        assert out.returncode == 0, out.stderr[-2000:]
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.strip().startswith("{")]
        assert len(lines) == 1, out.stdout
        rec = json.loads(lines[0])
        assert rec["value"] > 0
        device = rec["detail"]["device"]
        assert device["platform"] == "cpu"
        assert device["device_count"] >= 1
        assert "device_kind" in device
        assert rec["detail"]["mfu"] is None
        assert rec["detail"]["peak_bf16_flops"] == "none: cpu run"


class TestPeakTable:
    def test_h100_kind_resolves(self):
        dev = SimpleNamespace(platform="gpu",
                              device_kind="NVIDIA H100 80GB HBM3")
        assert bench_utils.device_peak_bf16_flops(dev) == 989e12
        assert bench_utils.device_peaks(dev)["hbm_bytes_per_s"] == 3.35e12

    def test_unknown_kind_raises(self):
        dev = SimpleNamespace(platform="gpu", device_kind="Some Other GPU")
        with pytest.raises(KeyError, match="Some Other GPU"):
            bench_utils.device_peak_bf16_flops(dev)


class TestDeviceOnlyCache:
    def test_other_device_kind_ignored(self, tmp_path):
        key = {"bucket": 512, "n_labels": 512, "compute_dtype": "bfloat16",
               "batch": 2048, "device_kind": "NVIDIA H100 80GB HBM3"}
        path = tmp_path / "cache.json"
        other = dict(key, device_kind="another accelerator")
        path.write_text(json.dumps({"config": other,
                                    "measurement": {"device_only_pps": 1.0}}))
        assert bench_utils.read_device_only_cache(str(path), key) is None
        path.write_text(json.dumps({"config": key,
                                    "measurement": {"device_only_pps": 2.0}}))
        assert bench_utils.read_device_only_cache(
            str(path), key) == {"device_only_pps": 2.0}
