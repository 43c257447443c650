"""The image height split over 2 x 2 ranks with the checks of
``tests/test_torch_spatial.py`` (float64, against one process and the
JAX package's spatial mesh step): two data shards of two bands at
128x64, a global batch of 4 of which 3 rows are real, the fourth a
masked repeat; one process steps on the 3 rows alone. The four gloo
ranks start with the file.
"""

from tests.test_torch_spatial import (check_band_heights, check_jax_losses,
                                      check_one_process, check_ranks_agree,
                                      layout_fixtures)

LAYOUT = dict(world=4, spatial=2, hw=(128, 64), batch=4, num_real=3)
inputs, launched, jax_results, ranks, reference = layout_fixtures(
    LAYOUT, seed=21)


def test_step_matches_jax_spatial_mesh(jax_results, ranks):
    """Against the JAX step on a 2 x 2 mesh, the padded row masked."""
    check_jax_losses(ranks, jax_results)


def test_step_and_eval_match_one_process(inputs, ranks, reference):
    check_one_process(ranks, reference, LAYOUT["world"], inputs)


def test_ranks_hold_equal_parameters(ranks):
    check_ranks_agree(ranks)


def test_activations_have_band_height(inputs, ranks):
    check_band_heights(ranks, inputs)


def test_halo_exchange_and_gather_rows_gradcheck(ranks):
    for r in ranks:
        assert r["gradcheck"] and r["gather_rows"]


def test_layout_places_ranks_as_the_jax_mesh(ranks):
    """Rank ``r`` is data shard ``r // 2`` and band ``r % 2``, as
    ``np.array(devices).reshape(-1, spatial)`` lays out the JAX mesh."""
    assert [(r["data_index"], r["space_index"]) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
