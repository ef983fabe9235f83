"""The step graphs under a mesh (pipeline/step_graphs.py, "Under a mesh"),
CPU: gloo jobs of two processes (tests/torch_parallel_worker.py, scenarios
mesh_graph_tp and mesh_graph_dp) on the small model, EOS off, where every
graph is replaced by a direct call of its body (DirectGraph, DirectPass:
the capture's warm-up runs its collectives once and each replay the body's,
the card's count of executed collectives) and held to the same calls op by
op, bit for bit. Port only: the op-by-op path is the one
test_torch_parallel.py holds to the JAX package."""

import json
import types

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch.pipeline import tts as ptts
from torch_parallel_worker import start_ranks, wait_ranks
from torch_port import write_small_config, write_small_port_checkpoint

TOKENS = [3, 17, 9, 21, 5, 23, 8]
BATCH_TOKENS = [[3, 7, 2], [9, 4, 8, 1, 6], [5, 5], [2, 9, 6, 1]]
BATCH_SEEDS = [10, 11, 12, 13]
JOB_S = 150.0  # each job's time limit: a rank that waits on a collective its peer never runs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_graph")
    ckpt, tok = write_small_port_checkpoint(tmp, seed=5)
    cfg = write_small_config(tmp, "mesh_graph", tok, weights_path=ckpt)
    rng = np.random.default_rng(6)
    D = 64
    inputs = {"cond": (rng.standard_normal((1, 180, D)) * 0.3).astype(np.float32),
              "wav": (rng.standard_normal((1, 4000)) * 0.1).astype(np.float32)}
    for b, n in enumerate((12, 5, 20, 9)):
        inputs[f"batch_cond_{b}"] = (rng.standard_normal((1, n, D)) * 0.3).astype(np.float32)
    meta = {"config": str(cfg), "dir": str(tmp), "tokens": TOKENS,
            "batch_tokens": BATCH_TOKENS, "batch_seeds": BATCH_SEEDS}
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "inputs.json").write_text(json.dumps(meta))
    return tmp, cfg


@pytest.fixture(scope="module")
def jobs(setup):
    """Both jobs at once, each rank's saved arrays by scenario."""
    tmp = setup[0]
    dirs = {name: tmp / name for name in ("mesh_graph_tp", "mesh_graph_dp")}
    procs = {}
    for name, d in dirs.items():
        d.mkdir()
        for f in ("inputs.npz", "inputs.json"):
            (d / f).write_bytes((tmp / f).read_bytes())
        procs[name] = start_ranks(2, name, d)
    try:
        for name in procs:
            wait_ranks(procs[name], JOB_S)
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()
                p.communicate()
    return {name: [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
            for name, d in dirs.items()}


@pytest.fixture(scope="module")
def tp(jobs):
    return jobs["mesh_graph_tp"]


@pytest.fixture(scope="module")
def dp(jobs):
    return jobs["mesh_graph_dp"]


def equal(a, b) -> bool:
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("case", ["seeded", "second", "injected"])
def test_tp_stream_graphed_equals_op_by_op(tp, case):
    """TP 1x2, copy_state False: a b1 stream on a seed whose 66 frames grow
    the cache from 256 to 384 slots (seeded), the next chunk of it in the
    same lane (second), and a stream on injected noise: the audio and the
    post-chunk state (k, v, pos, offset, write_pos) bit-equal, graphed and
    op by op, on both ranks; the audio the same on both ranks."""
    for rank in tp:
        assert rank[f"graphed_{case}_audio"].size > 0
        for name in ("audio", "k", "v", "pos", "offset", "write_pos"):
            assert equal(rank[f"graphed_{case}_{name}"], rank[f"eager_{case}_{name}"]), name
    assert equal(tp[0][f"graphed_{case}_audio"], tp[1][f"graphed_{case}_audio"])


def test_tp_voice_prompt_and_encoder_graphed_equal_op_by_op(tp):
    """The voice prompt under TP (its graph holds the layers' all-reduces)
    over a conditioning and over a cloned wav (the encoder first, which
    holds no collective): each rank's heads of the state bit-equal."""
    for rank in tp:
        for name in ("voice_k", "voice_v", "voice_pos", "voice_offset", "clone_k",
                     "clone_offset"):
            assert equal(rank[f"graphed_{name}"], rank[f"eager_{name}"]), name
        assert rank["graphed_voice_k"].shape[3] == 2  # 4 heads over 2 ranks


def test_tp_ranks_with_different_budgets_keep_alike(tp):
    """Rank 1's budget 0, rank 0's unbounded, two requests that cross 256 ->
    384 slots: both ranks keep by the least budget (nothing), so neither
    captures again where the other replays; the job ends in its time limit
    and the audio equals op by op bit for bit."""
    for rank in tp:
        assert equal(rank["budget_audio_0"], rank["eager_seeded_audio"])
        assert equal(rank["budget_audio_1"], rank["eager_fresh10_audio"])
        for i in range(2):
            assert rank[f"budget_kept_{i}"].tolist() == [""] and int(rank[f"budget_held_{i}"]) == 0
    assert "block B=1 K=32 C=384" in tp[0]["kept_unbounded"].tolist()


def test_tp_pool_growth_that_differs_by_rank_is_agreed(tp):
    """Each capture's pool grows by 1e9 bytes on rank 0 and 2e9 on rank 1
    (stand-ins): the group counts the largest, so under a budget one byte
    short of rank 0's holdings after an unbounded request both ranks drop
    the same slab (384, least recently used) after a 10-frame request and
    then the 256-slot one after a request that grows to 384 again; the keys
    and bytes kept are the same on both ranks and the audio equals op by
    op."""
    want = [["block B=1 K=1 C=256", "block B=1 K=8 C=256", "text (1, 8, 256)"],
            ["block B=1 K=32 C=384"]]
    for rank in tp:
        assert equal(rank["bytes_audio_0"], rank["eager_seeded_audio"])
        assert equal(rank["bytes_audio_1"], rank["eager_fresh10_audio"])
        assert equal(rank["bytes_audio_2"], rank["eager_seeded_audio"])
        for i in (1, 2):
            assert rank[f"bytes_kept_{i}"].tolist() == want[i - 1]
    for i in (1, 2):
        assert int(tp[0][f"bytes_held_{i}"]) == int(tp[1][f"bytes_held_{i}"])


def test_no_host_read_inside_a_mesh_graph_body(tp):
    """With every host read of a tensor made to raise (bool, item, tolist,
    cpu), a block with device noise (K=1), one with injected noise (K=8)
    and a text prompt run through on both ranks of the TP job: the bodies
    a graph holds, collectives included."""
    for rank in tp:
        assert bool(rank["host_read_guarded"])
        assert rank["host_read_shapes"].tolist() == [[1, 1, 1921], [8, 1, 1921]]


@pytest.mark.parametrize("kind", ["injected", "device"])
def test_dp_batch_graphed_equals_op_by_op(dp, kind):
    """DP 2x1, a ragged batch of 4 (voices of 12, 5, 20 and 9 frames,
    prompts of 2-5 tokens) on injected per-row noise and on device noise
    from a seed: every row, gathered on both ranks, bit-equal graphed and
    op by op."""
    for rank in dp:
        for b in range(4):
            got, want = rank[f"mesh_graphed_{kind}_{b}"], rank[f"mesh_eager_{kind}_{b}"]
            assert got.size > 0 and equal(got, want), b


@pytest.mark.parametrize("kind", ["injected", "device"])
def test_dp_rows_draw_the_unsharded_batchs_noise(dp, kind):
    """Each data rank's lane (rows 0-1 and 2-3 of 4) draws the whole
    batch's noise and keeps its rows, graphed (inside the body) and op by
    op: every block's noise equals the unsharded batch's rows."""
    for r, rank in enumerate(dp):
        whole = rank[f"unsharded_eager_{kind}_noise"]
        assert whole.shape[1] == 4
        for mode in ("graphed", "eager"):
            got = rank[f"mesh_{mode}_{kind}_noise"]
            assert equal(got, whole[:, 2 * r:2 * r + 2]), mode
        assert rank["rows"].tolist() == [[2 * r, 2 * r + 2]]


def test_gloo_mesh_runs_op_by_op(dp):
    """A gloo mesh's collectives cannot be captured: op by op."""
    assert not any(bool(rank["captures"]) for rank in dp)


def test_graphed_on_the_card_under_a_nccl_mesh():
    """_graphed(): on the card, unsharded or on a mesh whose collectives a
    graph can hold; never on the CPU or a gloo mesh."""
    for device, mesh, captures, want in (("cuda", None, False, True),
                                         ("cuda", object(), True, True),
                                         ("cuda", object(), False, False),
                                         ("cpu", None, False, False),
                                         ("cpu", object(), True, False)):
        m = types.SimpleNamespace(device=torch.device(device), mesh=mesh,
                                  _mesh_captures=captures)
        assert ptts.TTSModel._graphed(m) is want, (device, mesh, captures)


def test_lanes_are_keyed_by_rows_and_batch(setup, monkeypatch):
    """A graphed lane holds this rank's rows of a batch: two lanes with
    other rows or another batch are never shared; the same key gets the
    same free lane back."""
    from pocket_tts_tpu_torch.pipeline import step_graphs

    _, cfg = setup
    model = ptts.TTSModel.load_model(config=cfg, device="cpu")
    monkeypatch.setattr(model, "_graphed", lambda: True)
    sg = model.step_graphs
    lanes = {}
    for key in ((2, slice(0, 2), 4), (2, slice(2, 4), 4), (2, slice(0, 2), 2),
                (2, slice(None), None)):
        lane = sg.acquire(*key)
        assert (lane.B, lane.rows, lane.B_noise) == (2, key[1], key[2] or 2)
        lanes[key] = lane
        lane.close()
    assert len({id(lane) for lane in lanes.values()}) == 4
    assert sg.acquire(2, slice(2, 4), 4) is lanes[(2, slice(2, 4), 4)]
    assert isinstance(lanes[(2, slice(0, 2), 4)], step_graphs.Lane)
