"""Two real processes in one ``torch.distributed`` group: the port of
``tests/test_multihost.py`` (its worker: ``tests/torch_dist_worker.py
multihost``) and the port's ``dryrun_multichip``.

A mesh of one process leaves ``initialize_distributed``, the batch slices
and the cross-rank statistics untested; here two gloo ranks on the CPU
join through ``initialize_distributed`` with explicit arguments and run a
sharded staged sweep, ``statistics_scalar(distributed=True)`` and the
buffer's advantage normalization; both must agree, and with the
one-process sweep.
"""

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.codes import wifi_code
from ldpc_tpu_torch.dryrun import dryrun_multichip
from ldpc_tpu_torch.sim import evaluate_code
from torch_dist_worker import spawn_groups

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = spawn_groups("multihost", (2,), tmp_path_factory.mktemp("mh"),
                       timeout_s=180)
    return out[(2, 0)], out[(2, 1)]


def test_two_process_distributed_runtime(ranks):
    a, b = ranks
    assert (a["world"], a["rank"]) == (2, 0)
    assert (b["world"], b["rank"]) == (2, 1)
    assert a["slice"] == [0, 5] and b["slice"] == [5, 5]
    # the counters were summed over both ranks: identical statistics
    assert a["summary"] == b["summary"]
    assert a["summary"]["transmissions"] == 32
    single = evaluate_code(wifi_code(), [2.0, 4.0], 16, max_iters=12,
                           batch_size=16, seed=11, staged=True,
                           phase1_iters=4, device="cpu").summary()
    for k in ("ber", "fer", "avg_iterations"):
        assert a["summary"][k] == single[k], k


def test_statistics_scalar_across_processes(ranks):
    a, b = ranks
    # 0,1,2 on rank 0 with 10,11,12 on rank 1
    assert a["stat"] == b["stat"]
    mean, std, lo, hi = a["stat"]
    assert mean == pytest.approx(6.0)
    assert (lo, hi) == (0.0, 12.0)
    assert std == pytest.approx((370 / 6 - 36) ** 0.5, rel=1e-6)


def test_buffer_normalizes_advantages_globally(ranks):
    a, b = ranks
    raw = np.array(a["raw_adv"] + b["raw_adv"])
    np.testing.assert_allclose(a["adv_norm"] + b["adv_norm"],
                               (raw - raw.mean()) / raw.std(), rtol=1e-5)
    local = (np.array(a["raw_adv"]) - np.mean(a["raw_adv"])) / \
        np.std(a["raw_adv"])
    assert not np.allclose(a["adv_norm"], local)


def test_epoch_logger_writes_on_rank_0_only(ranks):
    a, b = ranks
    assert a["logger_wrote"] and not b["logger_wrote"]


def test_dryrun_multichip_two_ranks():
    """The port's dry run on two CPU ranks: each part checks itself (the
    staged step against one rank's, the row-sharded decoder against the
    unsharded one, the vector step, the PPO update) and raises if not."""
    reports = dryrun_multichip(2, device="cpu", timeout_s=180)
    assert [r["rank"] for r in reports] == [0, 1]
    assert reports[0]["staged"] == reports[1]["staged"]
    assert reports[0]["staged"]["frames"] == 4
    assert reports[0]["row_sharded"]["mesh"] == [1, 2]
    assert reports[0]["train_step"]["batch"] == 4
