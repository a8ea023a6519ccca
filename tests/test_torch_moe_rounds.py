"""Federated rounds on the MoE LM against the JAX package's, on the CPU:
test_torch_lm_train.py's round tests on the reduced granite-moe-3b-a800m
(E=4, k=2; K=2 clients, make_lm_tokens(8, 64), eta 0.3, L=3, the
reference's aa_impl="tree"), from the reference's initial params. One
FedSVRG round within 1e-4·‖Δw‖ and one FedOSAA-SVRG round within
1e-3·‖Δw‖ of the reference's; three rounds of each and launch/fl_train.py's
curve within rel 1e-3 of the reference's losses; one round of each of the
ten algorithms finite.
"""
import pytest

import test_torch_lm_train
from test_torch_lm_train import (test_every_algorithm_runs_a_round_on_the_lm,  # noqa: F401
                                 test_fl_train_tracks_reference,
                                 test_one_round_matches_reference,
                                 test_three_rounds_track_reference)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def fl():
    """test_torch_lm_train.py's round setup on the reduced granite."""
    return test_torch_lm_train.fl_setup("granite-moe-3b-a800m")
