"""The port's multi-process DP serving driver (pocket_tts_tpu_torch/parallel/
launch.py), the four cases of tests/test_multihost_launch.py on the CPU:
gloo workers (`--cpu`, one device each) serve one utterance batch; process 0
broadcasts it, each process decodes its rows, the audio is all-gathered, and
a heartbeat over the mesh brackets the run. Splitting the batch over
processes must not change the audio (per-global-row noise streams), a
worker that dies is recovered by a relaunch, and the relaunch decodes only
the rows the failed attempt did not save. `global_devices` is the number of
processes (one device each; the JAX driver counts 2 virtual devices per
process)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).parent.parent
TAG = "MULTIHOST_RESULT "
TIMEOUT = 120


def _cmd(processes: int, utterances: int) -> list[str]:
    return [sys.executable, "-m", "pocket_tts_tpu_torch.parallel.launch",
            "--processes", str(processes), "--cpu", "--tiny",
            "--utterances", str(utterances), "--seed", "3", "--timeout", str(TIMEOUT)]


def _report(stdout: str):
    report = None
    for line in stdout.splitlines():
        if line.startswith(TAG):
            report = json.loads(line[len(TAG):])
    return report


def _launch(processes: int, utterances: int = 4, tmpdir: Path | None = None) -> dict:
    env = None if tmpdir is None else dict(os.environ, TMPDIR=str(tmpdir))
    out = subprocess.run(_cmd(processes, utterances), cwd=REPO, capture_output=True,
                         text=True, timeout=TIMEOUT, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    report = _report(out.stdout)
    assert report is not None, f"no result line in output:\n{out.stdout}\n{out.stderr}"
    return report


@pytest.fixture(scope="module")
def launch_tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("launch_tmpdir")


@pytest.fixture(scope="module")
def two_proc(launch_tmp):
    return _launch(processes=2, tmpdir=launch_tmp)


def test_two_process_dp_serving(two_proc, launch_tmp):
    """With retries on (the default) and no --results-dir the launcher
    saves rows in a temporary dir of its own, and removes it at the end."""
    assert list(launch_tmp.iterdir()) == []
    r = two_proc
    assert r["processes"] == 2
    assert r["audio_rows"] == 4
    assert r["rows_per_process"] == 2
    assert r["global_devices"] == 2  # one device per process
    assert r["mesh_healthy"] is True
    assert all(s > 0 for s in r["row_samples"])


def _launch_with_fault(tmp_path, processes, utterances, fail_point):
    marker = tmp_path / "crash.marker"
    cmd = _cmd(processes, utterances) + ["--fail-once-marker", str(marker),
                                         "--fail-point", fail_point]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=2 * TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert marker.exists()  # the injected crash really happened
    assert "relaunching" in out.stderr
    report = _report(out.stdout)
    assert report is not None
    assert report["attempts"] == 2
    assert report["mesh_healthy"] and all(s > 0 for s in report["row_samples"])
    return report


def test_worker_failure_recovers_by_relaunch(tmp_path):
    """A worker dies on the first attempt (injected at init, before it joins
    the group); the launcher ends its peer, which waits in the group's
    rendezvous, and relaunches: attempt 2 decodes every row."""
    report = _launch_with_fault(tmp_path, processes=2, utterances=2, fail_point="init")
    assert report["rows_decoded"] == 2


def test_row_level_recovery_four_processes(tmp_path, two_proc):
    """Worker 1 crashes after every worker decoded and saved its row (after
    the barrier), deleting its own saved row first. The relaunch decodes
    ONLY that row, the other three come from the results dir, and the audio
    equals the healthy 2-process run of the same batch."""
    report = _launch_with_fault(tmp_path, processes=4, utterances=4, fail_point="after_decode")
    assert report["processes"] == 4
    assert report["rows_per_process"] == 1
    assert report["rows_decoded"] == 1  # only the deleted row is decoded again
    assert report["row_samples"] == two_proc["row_samples"]
    assert report["audio_checksum"] == pytest.approx(two_proc["audio_checksum"], rel=1e-5)


def test_process_sharding_is_audio_invariant(two_proc):
    """The same batch through 1 process and 2 processes gives the same audio
    (the same per-row noise, voices and tokens; only the split differs)."""
    r1 = _launch(processes=1)
    assert r1["row_samples"] == two_proc["row_samples"]
    assert r1["audio_checksum"] == pytest.approx(two_proc["audio_checksum"], rel=1e-5)
