// Native KITTI AP matching kernels.
//
// Replaces the reference's numba-JIT hot loops (engine/kitti_eval/eval.py:
// compute_statistics_jit:167, fused_compute_statistics:297) with a C++
// library bound via ctypes. The greedy matching is inherently sequential
// per image — exactly why the reference needed numba — so it lives here,
// while the batched IoU matrices stay vectorized in numpy.
//
// Build: g++ -O3 -ffp-contract=off -shared -fPIC kitti_match.cpp -o libkitti_match.so
// (NO -march=native / FMA contraction: rotate_pairs_kernel's bit-exactness
// contract with the numpy path depends on -ffp-contract=off — see below.
// native.py builds with exactly these flags.)

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kNoDetection = -10000000.0;

// Axis-aligned overlap with criterion=0 (intersection / det area), used for
// DontCare suppression (eval.py:90-119 with criterion 0).
inline double overlap_criterion0(const double* det, const double* dc) {
  const double iw = std::min(det[2], dc[2]) - std::max(det[0], dc[0]);
  if (iw <= 0) return 0.0;
  const double ih = std::min(det[3], dc[3]) - std::max(det[1], dc[1]);
  if (ih <= 0) return 0.0;
  const double area = (det[2] - det[0]) * (det[3] - det[1]);
  return area > 0 ? iw * ih / area : 0.0;
}

struct ImageView {
  const double* overlaps;  // (num_dt, num_gt) row-major
  const double* gt_alphas;
  const double* dt_alphas;
  const double* dt_scores;
  const double* dt_bboxes;  // (num_dt, 4)
  const double* dc_bboxes;  // (num_dc, 4)
  const int64_t* ignored_gt;
  const int64_t* ignored_dt;
  int64_t num_gt, num_dt, num_dc;
};

// One greedy matching pass (eval.py:167-285, compute_fp=true).
void match_one(const ImageView& im, int64_t metric, double min_overlap,
               double thresh, bool compute_aos, double* tp, double* fp,
               double* fn, double* similarity, bool* has_similarity) {
  std::vector<bool> assigned(im.num_dt, false);
  std::vector<bool> below(im.num_dt, false);
  for (int64_t j = 0; j < im.num_dt; ++j) {
    below[j] = im.dt_scores[j] < thresh;
  }

  double t = 0, f = 0, n = 0;
  std::vector<double> deltas;
  for (int64_t i = 0; i < im.num_gt; ++i) {
    if (im.ignored_gt[i] == -1) continue;
    int64_t det_idx = -1;
    double valid_detection = kNoDetection;
    double max_overlap = 0;
    bool assigned_ignored_det = false;

    for (int64_t j = 0; j < im.num_dt; ++j) {
      if (im.ignored_dt[j] == -1 || assigned[j] || below[j]) continue;
      const double overlap = im.overlaps[j * im.num_gt + i];
      if (overlap <= min_overlap) continue;
      if (im.ignored_dt[j] == 0 &&
          (overlap > max_overlap || assigned_ignored_det)) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1.0;
        assigned_ignored_det = false;
      } else if (im.ignored_dt[j] == 1 && valid_detection == kNoDetection) {
        det_idx = j;
        valid_detection = 1.0;
        assigned_ignored_det = true;
      }
    }

    if (valid_detection == kNoDetection && im.ignored_gt[i] == 0) {
      n += 1;
    } else if (valid_detection != kNoDetection &&
               (im.ignored_gt[i] == 1 || im.ignored_dt[det_idx] == 1)) {
      assigned[det_idx] = true;
    } else if (valid_detection != kNoDetection) {
      t += 1;
      if (compute_aos) deltas.push_back(im.gt_alphas[i] - im.dt_alphas[det_idx]);
      assigned[det_idx] = true;
    }
  }

  for (int64_t j = 0; j < im.num_dt; ++j) {
    if (!(assigned[j] || im.ignored_dt[j] == -1 || im.ignored_dt[j] == 1 ||
          below[j])) {
      f += 1;
    }
  }
  // DontCare suppression for the 2D metric (eval.py:258-272).
  if (metric == 0) {
    double nstuff = 0;
    for (int64_t i = 0; i < im.num_dc; ++i) {
      for (int64_t j = 0; j < im.num_dt; ++j) {
        if (assigned[j] || im.ignored_dt[j] == -1 || im.ignored_dt[j] == 1 ||
            below[j]) {
          continue;
        }
        if (overlap_criterion0(im.dt_bboxes + 4 * j, im.dc_bboxes + 4 * i) >
            min_overlap) {
          assigned[j] = true;
          nstuff += 1;
        }
      }
    }
    f -= nstuff;
  }

  double sim = 0;
  bool has_sim = false;
  if (compute_aos) {
    if (t > 0 || f > 0) {
      for (double d : deltas) sim += (1.0 + std::cos(d)) / 2.0;
      has_sim = true;
    }
  }
  *tp = t;
  *fp = f;
  *fn = n;
  *similarity = sim;
  *has_similarity = has_sim;
}

}  // namespace

extern "C" {

// Accumulate the PR table over all images and thresholds.
//   pr: (num_thresholds, 4) [tp, fp, fn, similarity], preinitialized to 0.
// Per-image arrays are flattened with exclusive prefix offsets.
void fused_pr(const double* overlaps, const int64_t* overlap_offsets,
              const double* gt_alphas, const int64_t* gt_offsets,
              const double* dt_alphas, const double* dt_scores,
              const double* dt_bboxes, const int64_t* dt_offsets,
              const int64_t* ignored_gt, const int64_t* ignored_dt,
              const double* dc_bboxes, const int64_t* dc_offsets,
              int64_t num_images, int64_t metric, double min_overlap,
              const double* thresholds, int64_t num_thresholds,
              int64_t compute_aos, double* pr) {
  for (int64_t img = 0; img < num_images; ++img) {
    ImageView im;
    im.num_gt = gt_offsets[img + 1] - gt_offsets[img];
    im.num_dt = dt_offsets[img + 1] - dt_offsets[img];
    im.num_dc = dc_offsets[img + 1] - dc_offsets[img];
    im.overlaps = overlaps + overlap_offsets[img];
    im.gt_alphas = gt_alphas + gt_offsets[img];
    im.dt_alphas = dt_alphas + dt_offsets[img];
    im.dt_scores = dt_scores + dt_offsets[img];
    im.dt_bboxes = dt_bboxes + 4 * dt_offsets[img];
    im.dc_bboxes = dc_bboxes + 4 * dc_offsets[img];
    im.ignored_gt = ignored_gt + gt_offsets[img];
    im.ignored_dt = ignored_dt + dt_offsets[img];

    for (int64_t t = 0; t < num_thresholds; ++t) {
      double tp, fp, fn, sim;
      bool has_sim;
      match_one(im, metric, min_overlap, thresholds[t], compute_aos != 0, &tp,
                &fp, &fn, &sim, &has_sim);
      pr[t * 4 + 0] += tp;
      pr[t * 4 + 1] += fp;
      pr[t * 4 + 2] += fn;
      if (has_sim) pr[t * 4 + 3] += sim;
    }
  }
}

// Threshold-selection matching (eval.py:167-285 with compute_fp=false):
// for every image, greedily match gts to the highest-score unassigned
// detection above min_overlap and emit the matched TP scores. These feed
// select_thresholds (the 41-recall-point grid). out_scores must hold at
// least sum(num_gt) doubles; returns the count written.
int64_t thresh_scores(const double* overlaps, const int64_t* overlap_offsets,
                      const double* dt_scores, const int64_t* dt_offsets,
                      const int64_t* ignored_gt, const int64_t* gt_offsets,
                      const int64_t* ignored_dt, int64_t num_images,
                      double min_overlap, double* out_scores) {
  int64_t written = 0;
  std::vector<bool> assigned;
  for (int64_t img = 0; img < num_images; ++img) {
    const int64_t num_gt = gt_offsets[img + 1] - gt_offsets[img];
    const int64_t num_dt = dt_offsets[img + 1] - dt_offsets[img];
    const double* ov = overlaps + overlap_offsets[img];
    const double* scores = dt_scores + dt_offsets[img];
    const int64_t* ig_gt = ignored_gt + gt_offsets[img];
    const int64_t* ig_dt = ignored_dt + dt_offsets[img];

    assigned.assign(num_dt, false);
    for (int64_t i = 0; i < num_gt; ++i) {
      if (ig_gt[i] == -1) continue;
      int64_t det_idx = -1;
      double valid_detection = kNoDetection;
      for (int64_t j = 0; j < num_dt; ++j) {
        if (ig_dt[j] == -1 || assigned[j]) continue;
        const double overlap = ov[j * num_gt + i];
        if (overlap <= min_overlap) continue;
        if (scores[j] > valid_detection) {
          det_idx = j;
          valid_detection = scores[j];
        }
      }
      if (valid_detection == kNoDetection) continue;
      if (ig_gt[i] == 1 || ig_dt[det_idx] == 1) {
        assigned[det_idx] = true;
      } else {
        out_scores[written++] = scores[det_idx];
        assigned[det_idx] = true;
      }
    }
  }
  return written;
}

}  // extern "C"

// Rotated-rectangle overlap for P aligned box pairs — the C++ twin of
// rotate_iou.py::rotate_iou_pairs (the numpy Sutherland–Hodgman clip),
// replacing the reference's numba.cuda kernel
// (engine/kitti_eval/rotate_iou.py:337-379) on the host eval path.
//
// Bit-exactness contract: this reproduces the numpy implementation's
// floating-point operation order exactly (same corner formulas, the same
// guarded segment-intersection parameter, and numpy's 8-accumulator
// pairwise order for the 10-slot shoelace sum), so outputs are
// bit-identical float32 to the Python path — tested by
// tests/test_rotate_iou_golden.py. Requires -ffp-contract=off (no FMA
// contraction); see native.py's build flags.

namespace {

constexpr int kMaxV = 10;  // quad ∩ quad has <= 8 vertices + slack

struct Pt {
  double x, y;
};

// (cx, cy, w, h, angle) -> 4 corners, CCW, clockwise rotation
// (rotate_iou.py::rbbox_corners).
inline void rbbox_corners_one(const double* b, Pt* c) {
  const double cx = b[0], cy = b[1], w = b[2], h = b[3];
  const double cosa = std::cos(b[4]), sina = std::sin(b[4]);
  const double dx[4] = {(-w) / 2.0, w / 2.0, w / 2.0, (-w) / 2.0};
  const double dy[4] = {(-h) / 2.0, (-h) / 2.0, h / 2.0, h / 2.0};
  for (int i = 0; i < 4; ++i) {
    c[i].x = cosa * dx[i] + sina * dy[i] + cx;
    c[i].y = -sina * dx[i] + cosa * dy[i] + cy;
  }
}

// One Sutherland–Hodgman pass: clip polygon (pts, count) by the half-plane
// left of edge a->b, emitting (kept vertex, crossing intersection) pairs in
// edge order exactly like rotate_iou.py::_clip_by_edge.
inline void clip_by_edge(const Pt* pts, int count, Pt a, Pt b, Pt* out,
                         int* out_count) {
  const double abx = b.x - a.x, aby = b.y - a.y;
  double side[kMaxV];
  for (int i = 0; i < count; ++i) {
    side[i] = abx * (pts[i].y - a.y) - aby * (pts[i].x - a.x);
  }
  int n = 0;
  for (int i = 0; i < count; ++i) {
    const int j = (i == count - 1) ? 0 : i + 1;
    const bool inside_i = side[i] >= 0.0;
    const bool inside_j = side[j] >= 0.0;
    if (inside_i && n < kMaxV) out[n++] = pts[i];
    if (inside_i != inside_j && n < kMaxV) {
      const double denom = side[i] - side[j];
      const double t = (std::fabs(denom) > 1e-12)
                           ? side[i] / (denom == 0.0 ? 1.0 : denom)
                           : 0.0;
      out[n].x = pts[i].x + t * (pts[j].x - pts[i].x);
      out[n].y = pts[i].y + t * (pts[j].y - pts[i].y);
      ++n;
    }
  }
  *out_count = n;
}

// Shoelace area of the padded polygon, summing the 10 edge cross terms in
// numpy's pairwise-reduction order for n=10 (8 unrolled accumulators
// combined as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then += c8, += c9) so
// the result is bit-identical to rotate_iou.py::_polygon_area.
inline double polygon_area(const Pt* pts, int count) {
  double c[kMaxV] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < count; ++i) {
    const int j = (i == count - 1) ? 0 : i + 1;
    c[i] = pts[i].x * pts[j].y - pts[j].x * pts[i].y;
  }
  double res = ((c[0] + c[1]) + (c[2] + c[3])) + ((c[4] + c[5]) + (c[6] + c[7]));
  res += c[8];
  res += c[9];
  return 0.5 * std::fabs(res);
}

}  // namespace

extern "C" {

// Elementwise rotated overlap for P aligned pairs (rotate_iou_pairs):
//   boxes, qboxes: (P, 5) float64 [cx, cy, w, h, angle]
//   area1, area2:  (P,) float64 (precomputed in the caller's input dtype,
//                  preserving the Python path's f32-multiply-then-widen)
//   criterion: -1 IoU, 0 inter/area2, 1 inter/area1 (the reference
//              arg-order quirk), 2 raw intersection.
//   out: (P,) float32
void rotate_pairs_kernel(const double* boxes, const double* qboxes,
                         const double* area1, const double* area2, int64_t p,
                         int64_t criterion, float* out) {
  for (int64_t k = 0; k < p; ++k) {
    Pt c1[4], c2[4];
    rbbox_corners_one(boxes + 5 * k, c1);
    rbbox_corners_one(qboxes + 5 * k, c2);

    Pt poly[kMaxV], next[kMaxV];
    int count = 4;
    for (int i = 0; i < 4; ++i) poly[i] = c1[i];
    for (int e = 0; e < 4; ++e) {
      clip_by_edge(poly, count, c2[e], c2[(e + 1) % 4], next, &count);
      for (int i = 0; i < count; ++i) poly[i] = next[i];
    }

    double inter = (count >= 3) ? polygon_area(poly, count) : 0.0;
    if (criterion == 2) {
      out[k] = static_cast<float>(inter);
      continue;
    }
    double denom;
    if (criterion == -1) {
      denom = area1[k] + area2[k] - inter;
    } else if (criterion == 0) {
      denom = area2[k];
    } else {
      denom = area1[k];
    }
    const double o =
        (denom > 0.0) ? inter / (denom == 0.0 ? 1.0 : denom) : 0.0;
    out[k] = static_cast<float>(o);
  }
}

}  // extern "C"
