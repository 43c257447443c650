"""The image height split over 1 x 4 ranks with the checks of
``tests/test_torch_spatial.py`` (float64, against one process and the
JAX package's spatial mesh step) at 320x64: the 10 rows of the H/32 map
split 3/3/2/2, so the bands are uneven (96/96/64/64 image rows) and the
two inner ones exchange halos on both sides. The four gloo ranks start
with the file.
"""

from tests.test_torch_spatial import (check_band_heights, check_jax_losses,
                                      check_one_process, check_ranks_agree,
                                      layout_fixtures)

LAYOUT = dict(world=4, spatial=4, hw=(320, 64), batch=2, num_real=2)
inputs, launched, jax_results, ranks, reference = layout_fixtures(
    LAYOUT, seed=22)


def test_step_matches_jax_spatial_mesh(jax_results, ranks):
    """Against the JAX step on a 1 x 4 mesh, whose GSPMD split of the
    deep map (3/3/3/1) differs from the port's."""
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


def test_bands_are_uneven_and_in_space_order(ranks):
    assert [r["band"] for r in ranks] == [
        (0, 96), (96, 192), (192, 256), (256, 320)]
    assert [r["space_index"] for r in ranks] == [0, 1, 2, 3]
