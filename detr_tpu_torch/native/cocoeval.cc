// COCO-eval matching kernels.
//
// The port's copy of the JAX package's native/cocoeval.cc: the same
// functions and extern "C" signatures.  The per-(image, class) greedy
// detection<->GT matching across IoU thresholds is the O(T * D * G) inner
// loop of COCO mAP; the protocol around it (sorting, accumulation, the
// 101-point interpolation) stays in numpy (detr_tpu_torch/eval/coco_eval.py),
// which also keeps a numpy matcher for hosts without a C++ toolchain.
//
// Semantics mirror pycocotools COCOeval.evaluateImg:
//   * crowd GT columns use det-area as the IoU denominator;
//   * detections iterate in score-descending order (pre-sorted by caller);
//   * GTs iterate real-first (pre-sorted by caller); a detection may steal
//     an ignored GT only if no real GT clears the threshold; taken non-crowd
//     GTs cannot rematch, crowd GTs can absorb multiple detections.
//
// Built lazily by detr_tpu_torch/eval/_native.py (g++ -O3) into
// build/native/.

#include <cstdint>

extern "C" {

// IoU matrix with crowd handling. boxes are XYXY doubles.
// dets: (n_det, 4), gts: (n_gt, 4), iscrowd: (n_gt,), out: (n_det, n_gt).
void iou_matrix(const double* dets, int n_det, const double* gts, int n_gt,
                const uint8_t* iscrowd, double* out) {
  for (int d = 0; d < n_det; ++d) {
    const double dx0 = dets[d * 4 + 0], dy0 = dets[d * 4 + 1];
    const double dx1 = dets[d * 4 + 2], dy1 = dets[d * 4 + 3];
    const double area_d = (dx1 > dx0 ? dx1 - dx0 : 0.0) * (dy1 > dy0 ? dy1 - dy0 : 0.0);
    for (int g = 0; g < n_gt; ++g) {
      const double gx0 = gts[g * 4 + 0], gy0 = gts[g * 4 + 1];
      const double gx1 = gts[g * 4 + 2], gy1 = gts[g * 4 + 3];
      const double area_g = (gx1 > gx0 ? gx1 - gx0 : 0.0) * (gy1 > gy0 ? gy1 - gy0 : 0.0);
      const double ix0 = dx0 > gx0 ? dx0 : gx0;
      const double iy0 = dy0 > gy0 ? dy0 : gy0;
      const double ix1 = dx1 < gx1 ? dx1 : gx1;
      const double iy1 = dy1 < gy1 ? dy1 : gy1;
      const double iw = ix1 > ix0 ? ix1 - ix0 : 0.0;
      const double ih = iy1 > iy0 ? iy1 - iy0 : 0.0;
      const double inter = iw * ih;
      const double denom = iscrowd[g] ? area_d : (area_d + area_g - inter);
      out[d * n_gt + g] = denom > 1e-12 ? inter / denom : 0.0;
    }
  }
}

// Greedy matching across IoU thresholds.
//
// ious:        (n_det, n_gt) from iou_matrix (dets score-desc sorted,
//              gts real-first sorted).
// gt_iscrowd:  (n_gt,)   gt_ignore: (n_gt,)
// thresholds:  (n_thr,)
// det_matched, det_matched_ignore: (n_thr, n_det) outputs.
void match_detections(const double* ious, int n_det, int n_gt,
                      const uint8_t* gt_iscrowd, const uint8_t* gt_ignore,
                      const double* thresholds, int n_thr,
                      uint8_t* det_matched, uint8_t* det_matched_ignore) {
  // thread-free scratch: caller guarantees n_gt small (COCO <= ~100)
  uint8_t taken[4096];
  for (int t = 0; t < n_thr; ++t) {
    for (int g = 0; g < n_gt && g < 4096; ++g) taken[g] = 0;
    for (int d = 0; d < n_det; ++d) {
      double best_iou = thresholds[t] < 1.0 - 1e-10 ? thresholds[t] : 1.0 - 1e-10;
      int best_g = -1;
      for (int g = 0; g < n_gt; ++g) {
        if (taken[g] && !gt_iscrowd[g]) continue;
        // gts sorted real-first: once we hold a real match, stop at ignored
        if (best_g > -1 && !gt_ignore[best_g] && gt_ignore[g]) break;
        const double iou = ious[d * n_gt + g];
        if (iou < best_iou) continue;
        best_iou = iou;
        best_g = g;
      }
      const int idx = t * n_det + d;
      if (best_g == -1) {
        det_matched[idx] = 0;
        det_matched_ignore[idx] = 0;
      } else {
        det_matched[idx] = 1;
        det_matched_ignore[idx] = gt_ignore[best_g];
        taken[best_g] = 1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Batched per-class evaluation (the COCOeval-opt design): one call covers
// EVERY image of a class, so that no Python dispatch runs per (image,
// class, area range).

// IoU matrices for n_img per-image blocks, written back-to-back.
// dets: (sum_D, 4) score-sorted within each image block; gts: (sum_G, 4);
// iscrowd: (sum_G,); d_off/g_off: (n_img+1,) int64 prefix offsets;
// out: sum over images of D_i*G_i doubles, image-major.
void iou_blocks(const double* dets, const double* gts, const uint8_t* iscrowd,
                const int64_t* d_off, const int64_t* g_off, int n_img,
                double* out) {
  int64_t o = 0;
  for (int i = 0; i < n_img; ++i) {
    const int64_t d0 = d_off[i], d1 = d_off[i + 1];
    const int64_t g0 = g_off[i], g1 = g_off[i + 1];
    const int n_det = static_cast<int>(d1 - d0);
    const int n_gt = static_cast<int>(g1 - g0);
    iou_matrix(dets + d0 * 4, n_det, gts + g0 * 4, n_gt, iscrowd + g0,
               out + o);
    o += static_cast<int64_t>(n_det) * n_gt;
  }
}

// Full per-class evaluate across images, IoU thresholds, and area ranges.
//
// ious:       from iou_blocks (base GT order; this function permutes
//             columns per range via an index, like the numpy path).
// iou_off:    (n_img+1,) int64 prefix offsets of the per-image IoU blocks.
// d_off/g_off:(n_img+1,) int64 det/GT prefix offsets.
// gt_iscrowd: (sum_G,)  g_area/d_area: box areas (sum_G,)/(sum_D,).
// thresholds: (n_thr,)  area_lo/area_hi: (n_ranges,).
// Outputs (caller-zeroed):
//   det_matched, det_matched_ignore: (n_ranges, n_thr, sum_D)
//   det_ignore_area:                 (n_ranges, sum_D)
//   num_gt:                          (n_ranges,) non-ignored GT totals
// Returns 0 on success, -1 if any image has more GTs than the scratch cap.
int evaluate_blocks(const double* ious, const int64_t* iou_off,
                    const int64_t* d_off, const int64_t* g_off, int n_img,
                    const uint8_t* gt_iscrowd, const double* g_area,
                    const double* d_area, const double* thresholds, int n_thr,
                    const double* area_lo, const double* area_hi, int n_ranges,
                    uint8_t* det_matched, uint8_t* det_matched_ignore,
                    uint8_t* det_ignore_area, int64_t* num_gt) {
  const int kMaxG = 4096;
  int perm[kMaxG];       // real-first stable GT order for this range
  uint8_t ign[kMaxG];    // g_ignore in permuted order
  uint8_t taken[kMaxG];
  int64_t sum_d = d_off[n_img];

  for (int i = 0; i < n_img; ++i) {
    const int64_t d0 = d_off[i];
    const int64_t g0 = g_off[i];
    const int n_det = static_cast<int>(d_off[i + 1] - d0);
    const int n_gt = static_cast<int>(g_off[i + 1] - g0);
    if (n_gt > kMaxG) return -1;
    const double* iou = ious + iou_off[i];

    for (int r = 0; r < n_ranges; ++r) {
      const double lo = area_lo[r], hi = area_hi[r];
      // Stable partition: real GTs first, ignored after (pycocotools
      // gtind ordering — argsort(g_ignore, kind="mergesort")).
      int n_real = 0, n_ign = 0;
      int ign_idx[kMaxG];
      for (int g = 0; g < n_gt; ++g) {
        const double a = g_area[g0 + g];
        const bool gi = gt_iscrowd[g0 + g] || a < lo || a > hi;
        if (gi) {
          ign_idx[n_ign++] = g;
        } else {
          perm[n_real++] = g;
        }
      }
      num_gt[r] += n_real;
      for (int k = 0; k < n_ign; ++k) {
        perm[n_real + k] = ign_idx[k];
        ign[n_real + k] = 1;
      }
      for (int k = 0; k < n_real; ++k) ign[k] = 0;

      for (int t = 0; t < n_thr; ++t) {
        uint8_t* dm = det_matched + (static_cast<int64_t>(r) * n_thr + t) * sum_d + d0;
        uint8_t* dmi = det_matched_ignore + (static_cast<int64_t>(r) * n_thr + t) * sum_d + d0;
        for (int g = 0; g < n_gt; ++g) taken[g] = 0;
        for (int d = 0; d < n_det; ++d) {
          double best_iou =
              thresholds[t] < 1.0 - 1e-10 ? thresholds[t] : 1.0 - 1e-10;
          int best_j = -1;
          for (int j = 0; j < n_gt; ++j) {
            const int g = perm[j];
            if (taken[j] && !gt_iscrowd[g0 + g]) continue;
            // real-first order: holding a real match, stop at ignored
            if (best_j > -1 && !ign[best_j] && ign[j]) break;
            const double v = iou[static_cast<int64_t>(d) * n_gt + g];
            if (v < best_iou) continue;
            best_iou = v;
            best_j = j;
          }
          if (best_j == -1) continue;
          dm[d] = 1;
          dmi[d] = ign[best_j];
          taken[best_j] = 1;
        }
      }

      uint8_t* dia = det_ignore_area + static_cast<int64_t>(r) * sum_d + d0;
      for (int d = 0; d < n_det; ++d) {
        const double a = d_area[d0 + d];
        dia[d] = (a < lo || a > hi) ? 1 : 0;
      }
    }
  }
  return 0;
}

}  // extern "C"
