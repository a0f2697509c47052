// Greedy COCO detection<->gt matching (the inner loop of COCOeval's
// evaluateImg) as a C ABI, called via ctypes from dp/coco_eval.py.
//
// The evaluation protocol itself lives in Python (oadp_torch/dp/
// coco_eval.py); this kernel only runs the O(T x D x G) greedy match
// per (image, category) pair — the one genuinely Python-bound hot loop
// of the host-side runtime (~325k pairs on COCO val). Semantics match
// pycocotools cocoeval.py exactly: crowd gts can be matched repeatedly,
// matching stops at ignored gts once a real gt is held, threshold
// min(t, 1-1e-10).
extern "C" {

// ious:      D x G row-major pairwise IoU
// g_ignore:  G (0/1)
// iscrowd:   G (0/1)
// thrs:      T iou thresholds
// out_match: T x D (0 = unmatched, 1+g = matched to gt g)
// out_ig:    T x D (0/1 dt-ignore flags from matched-gt ignore)
void match_pairs(
    const double* ious,
    const unsigned char* g_ignore,
    const unsigned char* iscrowd,
    const double* thrs,
    int n_dt,
    int n_gt,
    int n_thr,
    int* out_match,
    unsigned char* out_ig
) {
    for (int ti = 0; ti < n_thr; ++ti) {
        // per-threshold gt occupancy
        int* gtm = new int[n_gt]();
        for (int di = 0; di < n_dt; ++di) {
            double best = thrs[ti] < 1.0 - 1e-10 ? thrs[ti] : 1.0 - 1e-10;
            int m = -1;
            for (int gi = 0; gi < n_gt; ++gi) {
                if (gtm[gi] > 0 && !iscrowd[gi]) continue;
                if (m > -1 && !g_ignore[m] && g_ignore[gi]) break;
                double iou = ious[di * n_gt + gi];
                if (iou < best) continue;
                best = iou;
                m = gi;
            }
            if (m == -1) continue;
            out_match[ti * n_dt + di] = 1 + m;
            gtm[m] = 1 + di;
            out_ig[ti * n_dt + di] = g_ignore[m];
        }
        delete[] gtm;
    }
}

}  // extern "C"
