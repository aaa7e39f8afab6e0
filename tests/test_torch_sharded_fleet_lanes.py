"""The xor fleet of ``tests/test_torch_sharded_fleet.py`` on two ``(2, 1)``
sub-meshes of four ``gloo`` ranks (``carve_submeshes(2, model_axis=1)``:
ranks {0, 1} and {2, 3}, each replica two ``n_clusters`` lanes), held
against the reference's fleet on four XLA devices with the same checks:
records, epochs, suspects, failovers, resubmits, provenance, each
replica's batches and lanes, the followers' dispatches and ends.
"""
import pytest

from test_torch_sharded_fleet import CHECKS, fleet_runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return fleet_runs(tmp_path_factory, 1)


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_fleet_on_2x1_sub_meshes(runs, check):
    CHECKS[check](runs, 1)
