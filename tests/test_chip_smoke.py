"""chip_smoke.py on the CPU: its phases 2-4 at a tiny size (Pallas in
interpret mode), and its refusal to run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def test_phases_at_5k_docs(capsys):
    import chip_smoke

    chip_smoke.run(5000, b_pad=64)
    lines = capsys.readouterr().out.splitlines()
    phases = [line.split('"phase": "')[1].split('"')[0] for line in lines]
    assert phases == [
        "load",
        "kernel:phase_a_narrow",
        "kernel:phase_a_wide",
        "kernel:phase_a_packed",
        "kernel:block_scorer",
        "kernel:phrase_sweep_slop0",
        "kernel:phrase_sweep_slop2",
        "queries",
    ]


def test_device_check_refuses_cpu():
    import chip_smoke

    with pytest.raises(SystemExit) as e:
        chip_smoke.device_check()
    assert e.value.code != 0


def test_main_fails_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--docs", "100"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
