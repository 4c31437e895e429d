"""A run on the CPU, the harness's look for a card skipped, with the timed
path broken underneath: ``correct`` comes out false for each fault the
cells can have, and true without one."""

import pytest
import torch

import tiny


def _leaves(tree):
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        else:
            out.extend(_leaves(x))
    return out


@pytest.fixture
def unchanged_state(monkeypatch):
    """Every step hands back its state as it found it."""
    from stereo_svo_tpu_torch.engine import graphed
    for cls in (graphed.GraphedStep, graphed.GraphedBatchedStep):
        orig = cls.__call__

        def call(self, state, img_l, img_r, _orig=orig):
            before = [x.clone() for x in _leaves(self.state)]
            st, out = _orig(self, state, img_l, img_r)
            for x, b in zip(_leaves(self.state), before):
                x.copy_(b)
            return st, out
        monkeypatch.setattr(cls, "__call__", call)


@pytest.fixture
def half_batch_left_out(monkeypatch):
    """The batched step leaves its second half of sequences where they
    were."""
    from stereo_svo_tpu_torch.engine import graphed
    orig = graphed.GraphedBatchedStep.__call__

    def call(self, state, img_l, img_r):
        half = self.B // 2
        before = [x[half:].clone() for x in _leaves(self.state)]
        st, out = orig(self, state, img_l, img_r)
        for x, b in zip(_leaves(self.state), before):
            x[half:] = b
        return st, out
    monkeypatch.setattr(graphed.GraphedBatchedStep, "__call__", call)


@pytest.fixture
def altered_decision(monkeypatch):
    """One keyframe decision in six turned over where the step reports it
    (the pose and the state are left as they are)."""
    from stereo_svo_tpu_torch.engine import graphed
    for cls in (graphed.GraphedStep, graphed.GraphedBatchedStep):
        orig = cls.__call__

        def call(self, state, img_l, img_r, _orig=orig):
            st, out = _orig(self, state, img_l, img_r)
            self._bench_n = getattr(self, "_bench_n", 0) + 1
            if self._bench_n % 6 == 3:
                out.kf_inserted.logical_not_()
            return st, out
        monkeypatch.setattr(cls, "__call__", call)


@pytest.fixture
def altered_answer(monkeypatch):
    """One pose in six moved by 5 cm where the step produces it."""
    from stereo_svo_tpu_torch.engine import graphed
    for cls in (graphed.GraphedStep, graphed.GraphedBatchedStep):
        orig = cls.__call__

        def call(self, state, img_l, img_r, _orig=orig):
            st, out = _orig(self, state, img_l, img_r)
            self._bench_n = getattr(self, "_bench_n", 0) + 1
            if self._bench_n % 6 == 3:
                out.T_wc[..., 0, 3] += 0.05
            return st, out
        monkeypatch.setattr(cls, "__call__", call)


@pytest.mark.parametrize("cell", ["euroc.offline", "euroc.batch8"])
def test_sound_run_is_correct(cell):
    res = tiny.run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", ["euroc.offline", "euroc.batch8"])
def test_unchanged_state_fails(unchanged_state, cell):
    assert not tiny.run(cell)["correct"]


def test_half_batch_left_out_fails(half_batch_left_out):
    assert not tiny.run("euroc.batch8")["correct"]


@pytest.mark.parametrize("cell", ["euroc.offline", "euroc.batch8"])
def test_altered_answer_fails(altered_answer, cell):
    res = tiny.run(cell)
    assert not res["correct"]
    assert res["checks"]["pose_gap_m"]["value"] > \
        res["checks"]["pose_gap_m"]["limit"]


@pytest.mark.parametrize("cell", ["euroc.offline", "euroc.batch8"])
def test_altered_decision_fails(altered_decision, cell):
    res = tiny.run(cell)
    assert not res["correct"]
    assert res["checks"]["decision_mismatches"]["value"] > 0
