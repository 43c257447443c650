"""The port's drawing and visualizer against OpenCV and the JAX package's
on the CPU: each primitive of ``utils/draw.py`` against its ``cv2``
counterpart, the ``Visualizer``'s 2D, 3D and BEV plots against the JAX
package's on the same vis format (boxes partly behind the camera, corners
1e5 px outside the image), the PNG export, and ``MonoConEngine.visualize``
against the JAX engine's.

A drawing is judged per image on the pixels OpenCV changed:
  * core pixels (OpenCV's value and its 8 neighbours all at full ink)
    exact;
  * pixels more than 1 px from any pixel OpenCV changed exact (untouched);
  * the edge band between: per channel at most ``BAND_MAX`` levels off,
    and a mean difference of at most ``BAND_MEAN`` levels.
That is the loosest rule allowed. The tests hold what was measured (this
file, printed with ``-s``, on the CPU), which is tighter: every primitive
and plot is bit-equal to OpenCV's, but lines with an end 1e5 px out, whose
edge band is off by at most 3 levels (mean under 0.01), and circles, where
a pixel now and then is off by 1 level (the sine table's last digits). So
those two keep an edge band of ``FAR_LINE_BAND`` and ``CIRCLE_BAND``, the
3D plot (which draws such lines) the far lines' band, and everything else
must be equal to OpenCV's."""

import os

import cv2
import jax
import numpy as np
import pytest
from scipy.ndimage import binary_dilation, binary_erosion

from monocon_tpu.config import get_default_cfg as jax_default_cfg
from monocon_tpu.data import KITTIRawDataset as JaxRaw
from monocon_tpu.data.synthetic import generate_kitti_dataset as jax_generate
from monocon_tpu.data.transforms import \
    default_raw_transforms as jax_raw_transforms
from monocon_tpu.engine.engine import MonoConEngine as JaxEngine
from monocon_tpu.models import create_detector_state
from monocon_tpu.utils import visualizer as jax_visualizer
from monocon_tpu.utils.torch_convert import save_torch_checkpoint
from monocon_tpu_torch.config import get_default_cfg
from monocon_tpu_torch.data.kitti_raw import KITTIRawDataset
from monocon_tpu_torch.data.png import read_png
from monocon_tpu_torch.data.transforms import default_raw_transforms
from monocon_tpu_torch.engine.engine import MonoConEngine
from monocon_tpu_torch.utils import draw, visualizer
from test_torch_raw import P_RECT_02, assert_vis_close
from torch_port_helpers import perturb_variables

HW = (96, 320)
BAND_MAX, BAND_MEAN = 128, 24
# (max, mean) of the edge band, as measured; EXACT allows no band at all.
FAR_LINE_BAND = (3, 0.01)
CIRCLE_BAND = (1, 0.01)
EXACT = (0, 0.0)
BAND = {"line_far": FAR_LINE_BAND, "circle": CIRCLE_BAND,
        "3d": FAR_LINE_BAND}
FAR = 100_000
WHITE = (255, 255, 255)


def judge(ref, got, base):
    """(core max |diff|, untouched max |diff|, band max |diff|, band mean
    |diff|) of ``got`` against OpenCV's ``ref``, both drawn on ``base``."""
    changed = (ref != base).any(2)
    near = binary_dilation(changed, np.ones((3, 3), bool))
    diff = np.abs(ref.astype(int) - got.astype(int))
    # Full ink: a changed pixel whose 3x3 neighbourhood, all changed, has
    # one colour (no blend left in it).
    core = binary_erosion(changed, np.ones((3, 3), bool), border_value=1)
    core &= _flat(ref)
    band = diff[near & ~core]
    return (diff[core].max(initial=0), diff[~near].max(initial=0),
            band.max(initial=0), float(band.mean()) if band.size else 0.0)


def _flat(img):
    """Pixels whose 3x3 neighbourhood has one colour."""
    same = np.ones(img.shape[:2], bool)
    pad = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    for dy in range(3):
        for dx in range(3):
            same &= (pad[dy:dy + img.shape[0], dx:dx + img.shape[1]]
                     == img).all(2)
    return same


def assert_drawn_as_cv2(ref, got, base, what, band=EXACT):
    """The core/untouched/edge-band rule, with the edge band held to
    ``band`` (max, mean), itself within ``BAND_MAX`` / ``BAND_MEAN``."""
    assert band[0] <= BAND_MAX and band[1] <= BAND_MEAN
    core, untouched, band_max, band_mean = judge(ref, got, base)
    assert core == 0, f"{what}: core pixels off by {core}"
    assert untouched == 0, f"{what}: untouched pixels off by {untouched}"
    assert band_max <= band[0], f"{what}: edge band off by {band_max}"
    assert band_mean <= band[1], f"{what}: edge band mean {band_mean}"
    if band == EXACT:
        np.testing.assert_array_equal(got, ref, err_msg=what)
    return band_max, band_mean


def _point(rng, span):
    return tuple(int(v) for v in rng.uniform((-span, -span),
                                             (HW[1] + span, HW[0] + span)))


def _primitive(kind, rng, base, color):
    """(OpenCV's drawing, the port's) of one random primitive."""
    a, b = base.copy(), base.copy()
    if kind in ("line", "line_far"):
        p, q = _point(rng, FAR if kind == "line_far" else 40), _point(rng, 20)
        return (cv2.line(a, p, q, color, 2, cv2.LINE_AA),
                draw.line(b, p, q, color))
    if kind in ("rectangle", "rectangle_far"):
        p = _point(rng, FAR if kind == "rectangle_far" else 30)
        q = _point(rng, 30)
        return (cv2.rectangle(a, p, q, color, 2, cv2.LINE_AA),
                draw.rectangle(b, p, q, color, 2))
    if kind == "circle":
        c, r = _point(rng, 0), int(rng.integers(1, 200))
        return (cv2.circle(a, c, r, color, 2, cv2.LINE_AA),
                draw.circle(b, c, r, color))
    span = FAR if kind == "fill_poly_far" else 50
    size = rng.uniform(0, 2 * FAR if kind == "fill_poly_far" else 150, 2)
    rect = (rng.uniform((-span, -span), (HW[1] + span, HW[0] + span)),
            size, float(rng.uniform(-180, 180)))
    pts = cv2.boxPoints(rect).astype(np.int32)
    return (cv2.drawContours(a, [pts], -1, color, -1, cv2.LINE_AA),
            draw.fill_poly(b, pts, color))


@pytest.mark.parametrize("kind", ["line", "line_far", "rectangle",
                                  "rectangle_far", "circle", "fill_poly",
                                  "fill_poly_far"])
def test_primitive_drawn_as_cv2(kind, rng):
    """40 random primitives of one kind on random backgrounds, in random
    colours: ``_far`` ones have a point up to 1e5 px outside the image."""
    worst = [0, 0.0]
    for i in range(40):
        base = rng.integers(0, 256, (*HW, 3), np.uint8)
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        ref, got = _primitive(kind, rng, base, color)
        band_max, band_mean = assert_drawn_as_cv2(
            ref, got, base, f"{kind} {i}", BAND.get(kind, EXACT))
        worst = [max(worst[0], band_max), max(worst[1], band_mean)]
    print(f"{kind}: edge band max {worst[0]}, largest mean {worst[1]:.2f}")


def test_filled_rectangle_is_exact(rng):
    for _ in range(50):
        base = rng.integers(0, 256, (*HW, 3), np.uint8)
        p, q = _point(rng, FAR), _point(rng, 30)
        np.testing.assert_array_equal(
            draw.rectangle(base.copy(), p, q, (9, 99, 199), -1),
            cv2.rectangle(base.copy(), p, q, (9, 99, 199), -1))


def test_add_weighted_is_exact(rng):
    a = rng.integers(0, 256, (*HW, 3), np.uint8)
    b = rng.integers(0, 256, (*HW, 3), np.uint8)
    for alpha, beta, gamma in ((0.2, 0.8, 0), (0.5, 0.5, 0), (0.3, 0.9, 7.5)):
        np.testing.assert_array_equal(draw.add_weighted(a, alpha, b, beta,
                                                        gamma),
                                      cv2.addWeighted(a, alpha, b, beta,
                                                      gamma))


def test_box_points_exact_after_the_int32_cast(rng):
    """The BEV's rectangles: centres, sizes and angles as the visualizer
    hands them to ``cv2.boxPoints``."""
    for _ in range(2000):
        center = tuple(rng.uniform(-2000, 2000, 2))
        size = tuple(rng.uniform(0, 500, 2))
        angle = float(rng.uniform(-400, 400))
        got = draw.box_points(center, size, angle)
        want = cv2.boxPoints((center, size, angle))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.astype(np.int32),
                                      want.astype(np.int32))


@pytest.mark.parametrize("p", [(-2**31, -2**31), (2**31 - 1, 50),
                               (float("inf"), 0), (float("nan"), 3)],
                         ids=["int_min", "int_max", "inf", "nan"])
def test_extreme_coordinates_neither_raise_nor_hang(p):
    img = np.zeros((*HW, 3), np.uint8)
    draw.line(img, p, (100, 50), WHITE)
    draw.rectangle(img, p, (100, 50), WHITE, 2)
    draw.rectangle(img, p, (100, 50), WHITE, -1)
    pts = np.array([p, (100, 50), (120, 60), (90, 70)], np.float64)
    with np.errstate(invalid="ignore"):
        draw.fill_poly(img, pts.astype(np.int32), WHITE)
    draw.fill_poly(img, pts, WHITE)


# ---------------------------------------------------------------- visualizer
@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    root = tmp_path_factory.mktemp("vis_drive")
    frames = root / "frames"
    frames.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        cv2.imwrite(str(frames / f"{i:010d}.png"),
                    rng.integers(0, 255, (*HW, 3), np.uint8))
    calib = root / "calib_cam_to_cam.txt"
    calib.write_text(P_RECT_02)
    return (KITTIRawDataset(str(frames), str(calib),
                            default_raw_transforms(True)),
            JaxRaw(str(frames), str(calib), jax_raw_transforms(True)))


def _vis_format(rng, n=30):
    """Random detections in vis format: 3D boxes near the camera (some
    corners behind it, none within 0.2 m of its plane), a few far to the
    side (1e5 px out of the image and the BEV), 2D boxes some of which
    reach 1e5 px out."""
    boxes = []
    while len(boxes) < n:
        loc = rng.uniform((-15, -2, -4), (15, 2.5, 45))
        dims = rng.uniform((1, 1, 1), (5, 3, 5))
        ry = rng.uniform(-np.pi, np.pi)
        if len(boxes) < 3:
            loc[0] = rng.choice([-1, 1]) * rng.uniform(5e3, 1e4)
        corners = jax_visualizer.boxes3d_to_corners(
            loc[None], dims[None], np.array([ry]))[0]
        if np.abs(corners[:, 2]).min() < 0.2:
            continue
        boxes.append(np.concatenate([loc, dims, [ry]]))
    labels = rng.integers(0, 3, n)
    scores = rng.uniform(0.1, 1.0, n)
    x1y1 = rng.uniform(-40, (HW[1] + 20, HW[0] + 20), (n, 2))
    wh = rng.uniform(1, 150, (n, 2))
    bbox2d = np.concatenate([x1y1, x1y1 + wh, scores[:, None]], 1)
    bbox2d[:3, :2] -= FAR
    bbox2d[3:5, 2:4] += FAR
    return {"img_bbox": {"boxes_3d": np.array(boxes, np.float32),
                         "scores_3d": scores.astype(np.float32),
                         "labels_3d": labels},
            "img_bbox2d": [bbox2d[labels == c].astype(np.float32)
                           for c in range(3)]}


@pytest.mark.parametrize("item", ["2d", "3d", "bev"])
def test_plots_drawn_as_jax(drive, item, rng):
    """The port's and the JAX package's ``Visualizer`` on the same frames
    and vis format, judged per image as the primitives are; the BEV canvas
    with its polar grid alone too."""
    ours, theirs = drive
    vis = [_vis_format(rng) for _ in range(len(ours))]
    port = visualizer.Visualizer(ours, vis)
    jax_vis = jax_visualizer.Visualizer(theirs, vis)
    assert port.mode == jax_vis.mode == "raw"
    name = {"2d": "plot_bboxes_2d", "3d": "plot_bboxes_3d",
            "bev": "plot_bev"}[item]
    for i in range(len(ours)):
        got, want = getattr(port, name)(i), getattr(jax_vis, name)(i)
        assert got.shape == want.shape and got.dtype == np.uint8
        base = (np.zeros_like(want) if item == "bev"
                else theirs[i]["ori_img"][0])
        band_max, band_mean = assert_drawn_as_cv2(
            want, got, base, f"{item} frame {i}", BAND.get(item, EXACT))
        print(f"{item} frame {i}: edge band max {band_max}, mean "
              f"{band_mean:.2f}")
    if item == "bev":
        empty = {"boxes_3d": np.zeros((0, 7), np.float32),
                 "scores_3d": np.zeros(0, np.float32),
                 "labels_3d": np.zeros(0, np.int64)}
        vis = [{"img_bbox": empty, "img_bbox2d": []}] * len(ours)
        grid = visualizer.Visualizer(ours, vis).plot_bev(0)
        want = jax_visualizer.Visualizer(theirs, vis).plot_bev(0)
        assert_drawn_as_cv2(want, grid, np.zeros_like(want), "BEV grid")


def test_export_writes_png_sequences(drive, tmp_path, rng):
    """One numbered PNG per frame and item, bit-equal to the plots."""
    ours, _ = drive
    vis = [_vis_format(rng, 5) for _ in range(len(ours))]
    port = visualizer.Visualizer(ours, vis)
    port.export_as_video(str(tmp_path), ["2d", "3d", "bev"], fps=5)
    for item, plot in (("2d", port.plot_bboxes_2d),
                       ("3d", port.plot_bboxes_3d), ("bev", port.plot_bev)):
        names = sorted(os.listdir(tmp_path / item))
        assert names == [f"{i:06d}.png" for i in range(len(ours))]
        for i, name in enumerate(names):
            np.testing.assert_array_equal(read_png(tmp_path / item / name),
                                          plot(i))


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def vis_tree(tmp_path_factory):
    """A 4-image val split and a ``.pth`` of JAX DLA-34 variables (random
    BN state, center-heatmap bias 0.5)."""
    root = tmp_path_factory.mktemp("kitti_vis")
    jax_generate(str(root), num_train=1, num_val=4, image_hw=HW, seed=9)
    _, variables = create_detector_state(jax.random.PRNGKey(1),
                                         num_layers=34, image_hw=(64, 96))
    variables = perturb_variables(variables, np.random.default_rng(9))
    variables["params"]["heads"]["heatmap"]["conv2"]["bias"][:] = 0.5
    pth = root / "model.pth"
    save_torch_checkpoint(variables, str(pth))
    return root, pth


def test_engine_visualize_matches_jax(vis_tree, tmp_path, monkeypatch):
    """``MonoConEngine.visualize`` on the same tree and ``.pth`` as the JAX
    engine's: the same files, and the vis format it drew within F32_TOL,
    but for one NMS tie a frame: on this tree one frame has two
    neighbouring center-heatmap cells whose float32 values are equal in the
    port and one ulp apart in JAX, so the port keeps a detection that JAX
    drops, and the last detection of JAX's top 30 falls out."""
    root, pth = vis_tree
    drawn = {}

    def recording(module, key):
        class Recording(module.Visualizer):
            def __init__(self, dataset, vis_format, scale_hw=None):
                drawn[key] = vis_format
                super().__init__(dataset, vis_format, scale_hw)
        monkeypatch.setattr(module, "Visualizer", Recording)

    recording(visualizer, "port")
    recording(jax_visualizer, "jax")
    for package, cfg in (("jax", jax_default_cfg()),
                         ("port", get_default_cfg())):
        cfg.DATA.ROOT = str(root)
        cfg.DATA.BATCH_SIZE = 3     # 4 images: the last batch is short
        cfg.DATA.NUM_WORKERS = 1
        cfg.TPU.PAD_HW = list(HW)
        if package == "jax":
            engine = JaxEngine(cfg, is_test=True)
        else:
            engine = MonoConEngine(cfg, is_test=True, device="cpu")
        engine.load_checkpoint(str(pth))
        engine.visualize(str(tmp_path / package))
    names = sorted(f"{i:06d}.png" for i in range(1, 5))
    for item in ("2d", "3d", "bev"):
        assert sorted(os.listdir(tmp_path / "port" / item)) == names
        assert sorted(os.listdir(tmp_path / "jax" / item)) == names
    assert sum(len(v["img_bbox"]["labels_3d"]) for v in drawn["jax"]) > 0
    assert_vis_close(drawn["port"], drawn["jax"], nms_ties=1)
