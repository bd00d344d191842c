// Waymo-style detection metrics: rotated-box IoU, Hungarian matching,
// AP/APH computation, and the standalone CLI binary.
//
// Native rebuild of the reference's prebuilt ELF tools
// (src/waymo/compute_detection_metrics_{main,fast}; invoked at
// src/waymo/linear_matching.py:478-484) and of the py_metrics_ops.match TF
// custom op (linear_matching.py:110-118). Same CLI contract: two .bin paths
// (pred, gt) of metrics Objects; stdout lines
//   OBJECT_TYPE_TYPE_<T>_LEVEL_<K>: [mAP x] [mAPH y]
// which the alpha-search parser splits on "mAP " / "mAPH ".
//
// Build (see cm3d_tpu_torch/eval/waymo_metrics.py):
//   g++ -O2 -std=c++17 -DMETRICS_MAIN waymo_metrics.cc -o compute_detection_metrics_main
//   g++ -O2 -std=c++17 -shared -fPIC waymo_metrics.cc -o libwaymo_metrics.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Rotated-box geometry (BEV convex polygon intersection + z overlap).
// ---------------------------------------------------------------------------

struct Pt { double x, y; };

// corners of a BEV box (cx, cy, length along heading, width across)
static void box_corners(double cx, double cy, double l, double w, double yaw,
                        Pt out[4]) {
  const double c = std::cos(yaw), s = std::sin(yaw);
  const double dx[4] = {l / 2, l / 2, -l / 2, -l / 2};
  const double dy[4] = {w / 2, -w / 2, -w / 2, w / 2};
  for (int i = 0; i < 4; i++) {
    out[i].x = cx + dx[i] * c - dy[i] * s;
    out[i].y = cy + dx[i] * s + dy[i] * c;
  }
}

static double polygon_area(const std::vector<Pt>& p) {
  double a = 0;
  const size_t n = p.size();
  for (size_t i = 0; i < n; i++) {
    const size_t j = (i + 1) % n;
    a += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  return std::fabs(a) / 2;
}

// Sutherland-Hodgman clip of subject polygon by convex clip polygon.
static std::vector<Pt> clip_polygon(std::vector<Pt> subject, const Pt* clip,
                                    int nclip) {
  for (int e = 0; e < nclip && !subject.empty(); e++) {
    const Pt a = clip[e];
    const Pt b = clip[(e + 1) % nclip];
    std::vector<Pt> out;
    const size_t n = subject.size();
    for (size_t i = 0; i < n; i++) {
      const Pt p = subject[i];
      const Pt q = subject[(i + 1) % n];
      const double side_p = (b.x - a.x) * (p.y - a.y) - (b.y - a.y) * (p.x - a.x);
      const double side_q = (b.x - a.x) * (q.y - a.y) - (b.y - a.y) * (q.x - a.x);
      if (side_p >= 0) {
        out.push_back(p);
        if (side_q < 0) {
          const double t = side_p / (side_p - side_q);
          out.push_back({p.x + t * (q.x - p.x), p.y + t * (q.y - p.y)});
        }
      } else if (side_q >= 0) {
        const double t = side_p / (side_p - side_q);
        out.push_back({p.x + t * (q.x - p.x), p.y + t * (q.y - p.y)});
      }
    }
    subject = std::move(out);
  }
  return subject;
}

}  // namespace

// box: [cx, cy, cz, width, length, height, heading] (center z).
static double bev_intersection(const double* a, const double* b) {
  Pt ca[4], cb[4];
  box_corners(a[0], a[1], a[4], a[3], a[6], ca);
  box_corners(b[0], b[1], b[4], b[3], b[6], cb);
  // ensure counter-clockwise clip polygon for half-plane test
  std::vector<Pt> subject(ca, ca + 4);
  // our corner order is clockwise in math coords; reverse for CCW
  std::reverse(subject.begin(), subject.end());
  Pt clipccw[4] = {cb[3], cb[2], cb[1], cb[0]};
  auto inter = clip_polygon(subject, clipccw, 4);
  if (inter.size() < 3) return 0.0;
  return polygon_area(inter);
}

extern "C" double box_iou_7dof(const double* a, const double* b, int mode_2d) {
  const double inter_bev = bev_intersection(a, b);
  const double area_a = a[3] * a[4];
  const double area_b = b[3] * b[4];
  if (mode_2d) {
    const double u = area_a + area_b - inter_bev;
    return u > 0 ? inter_bev / u : 0.0;
  }
  const double za0 = a[2] - a[5] / 2, za1 = a[2] + a[5] / 2;
  const double zb0 = b[2] - b[5] / 2, zb1 = b[2] + b[5] / 2;
  const double zo = std::max(0.0, std::min(za1, zb1) - std::max(za0, zb0));
  const double inter = inter_bev * zo;
  const double u = area_a * a[5] + area_b * b[5] - inter;
  return u > 0 ? inter / u : 0.0;
}

// ---------------------------------------------------------------------------
// Hungarian assignment (max total IoU), O(n^3) Jonker-Volgenant style.
// ---------------------------------------------------------------------------

// cost matrix [n x m] of NEGATED gains; returns assignment pred->gt (-1 none)
static void hungarian(const std::vector<double>& cost, int n, int m,
                      std::vector<int>& match_row) {
  const int dim = std::max(n, m);
  const double INF = 1e18;
  std::vector<double> u(dim + 1), v(dim + 1);
  std::vector<int> p(dim + 1), way(dim + 1);
  auto c = [&](int i, int j) -> double {
    if (i < n && j < m) return cost[(size_t)i * m + j];
    return 0.0;  // padding
  };
  for (int i = 1; i <= dim; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(dim + 1, INF);
    std::vector<char> used(dim + 1, false);
    do {
      used[j0] = true;
      int i0 = p[j0], j1 = -1;
      double delta = INF;
      for (int j = 1; j <= dim; ++j) {
        if (used[j]) continue;
        const double cur = c(i0 - 1, j - 1) - u[i0] - v[j];
        if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
        if (minv[j] < delta) { delta = minv[j]; j1 = j; }
      }
      for (int j = 0; j <= dim; ++j) {
        if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
        else minv[j] -= delta;
      }
      j0 = j1;
    } while (p[j0] != 0);
    do { int j1 = way[j0]; p[j0] = p[j1]; j0 = j1; } while (j0);
  }
  match_row.assign(n, -1);
  for (int j = 1; j <= dim; ++j) {
    if (p[j] >= 1 && p[j] <= n && j <= m) match_row[p[j] - 1] = j - 1;
  }
}

// extern C matcher for the fusion stage (py ctypes): boxes are
// [cx, cy, cz, width, length, height, heading] row-major.
extern "C" int hungarian_match_boxes(
    const double* pred, int n, const double* gt, int m, double iou_thresh,
    int mode_2d, int* out_pred_idx, int* out_gt_idx, double* out_iou) {
  if (n == 0 || m == 0) return 0;
  std::vector<double> iou((size_t)n * m, 0.0);
  std::vector<double> cost((size_t)n * m, 0.0);
  for (int i = 0; i < n; i++) {
    for (int j = 0; j < m; j++) {
      const double v = box_iou_7dof(pred + 7 * i, gt + 7 * j, mode_2d);
      iou[(size_t)i * m + j] = v;
      cost[(size_t)i * m + j] = v >= iou_thresh ? -v : 0.0;
    }
  }
  std::vector<int> match_row;
  hungarian(cost, n, m, match_row);
  int q = 0;
  for (int i = 0; i < n; i++) {
    const int j = match_row[i];
    if (j >= 0 && iou[(size_t)i * m + j] >= iou_thresh) {
      out_pred_idx[q] = i;
      out_gt_idx[q] = j;
      out_iou[q] = iou[(size_t)i * m + j];
      q++;
    }
  }
  return q;
}

#ifdef METRICS_MAIN

namespace {

// ---------------------------------------------------------------------------
// Proto wire decoding (schema: cm3d_tpu_torch/datasets/waymo/proto.py).
// ---------------------------------------------------------------------------

struct Obj {
  double box[7];  // cx cy cz w l h heading
  int type = 0;
  int num_points = 0;
  double score = 0;
  int64_t ts = 0;
  std::string context;
};

struct Cursor { const uint8_t* p; const uint8_t* end; };

static uint64_t read_varint(Cursor& c) {
  uint64_t x = 0; int shift = 0;
  while (c.p < c.end) {
    uint8_t b = *c.p++;
    x |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  return x;
}

static void parse_box(const uint8_t* p, size_t len, double* box) {
  Cursor c{p, p + len};
  while (c.p < c.end) {
    const uint64_t key = read_varint(c);
    const int field = (int)(key >> 3), wire = (int)(key & 7);
    if (wire == 1) {
      double v; std::memcpy(&v, c.p, 8); c.p += 8;
      // schema: cx=1 cy=2 cz=3 width=4 length=5 height=6 heading=7
      static const int slot[8] = {-1, 0, 1, 2, 3, 4, 5, 6};
      if (field >= 1 && field <= 7) box[slot[field]] = v;
    } else if (wire == 2) {
      const uint64_t ln = read_varint(c); c.p += ln;
    } else if (wire == 0) {
      read_varint(c);
    } else if (wire == 5) { c.p += 4; }
  }
}

static void parse_label(const uint8_t* p, size_t len, Obj& o) {
  Cursor c{p, p + len};
  while (c.p < c.end) {
    const uint64_t key = read_varint(c);
    const int field = (int)(key >> 3), wire = (int)(key & 7);
    if (wire == 2) {
      const uint64_t ln = read_varint(c);
      if (field == 1) parse_box(c.p, ln, o.box);
      c.p += ln;
    } else if (wire == 0) {
      const uint64_t v = read_varint(c);
      if (field == 3) o.type = (int)v;
      if (field == 7) o.num_points = (int)v;
    } else if (wire == 1) { c.p += 8; }
    else if (wire == 5) { c.p += 4; }
  }
}

static void parse_object(const uint8_t* p, size_t len, Obj& o) {
  Cursor c{p, p + len};
  while (c.p < c.end) {
    const uint64_t key = read_varint(c);
    const int field = (int)(key >> 3), wire = (int)(key & 7);
    if (wire == 2) {
      const uint64_t ln = read_varint(c);
      if (field == 1) parse_label(c.p, ln, o);
      else if (field == 5) o.context.assign((const char*)c.p, ln);
      c.p += ln;
    } else if (wire == 5) {
      if (field == 2) { float f; std::memcpy(&f, c.p, 4); o.score = f; }
      c.p += 4;
    } else if (wire == 0) {
      const uint64_t v = read_varint(c);
      if (field == 4) o.ts = (int64_t)v;
    } else if (wire == 1) { c.p += 8; }
  }
}

static std::vector<Obj> load_bin(const char* path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) { std::fprintf(stderr, "cannot open %s\n", path); std::exit(2); }
  std::vector<uint8_t> buf((std::istreambuf_iterator<char>(f)),
                            std::istreambuf_iterator<char>());
  std::vector<Obj> out;
  Cursor c{buf.data(), buf.data() + buf.size()};
  while (c.p < c.end) {
    const uint64_t key = read_varint(c);
    const int field = (int)(key >> 3), wire = (int)(key & 7);
    if (field == 1 && wire == 2) {
      const uint64_t ln = read_varint(c);
      Obj o;
      parse_object(c.p, ln, o);
      c.p += ln;
      out.push_back(std::move(o));
    } else break;
  }
  return out;
}

// ---------------------------------------------------------------------------
// AP/APH per (type, difficulty level).
// ---------------------------------------------------------------------------

struct TypeCfg { int type; const char* name; double iou; };
static const TypeCfg kTypes[] = {
    {1, "VEHICLE", 0.7},
    {2, "PEDESTRIAN", 0.5},
    {3, "SIGN", 0.5},
    {4, "CYCLIST", 0.5},
};

// Waymo heading accuracy weight: 1 - |wrapped yaw diff| / pi.
static double heading_weight(double a, double b) {
  double d = std::fabs(a - b);
  d = std::fmod(d, 2 * M_PI);
  if (d > M_PI) d = 2 * M_PI - d;
  return std::max(0.0, 1.0 - d / M_PI);
}

// BEV center range of a box (Waymo RANGE breakdown shards by it).
static double box_range(const Obj* o) {
  return std::sqrt(o->box[0] * o->box[0] + o->box[1] * o->box[1]);
}

// GT difficulty semantics, pinned EMPIRICALLY against the reference repo's
// real compute_detection_metrics_main ELF (single-object probe bins, see
// tests/test_waymo_metrics_live.py):
//   - num_points == 0  -> gt excluded entirely (no match, no npos, either
//     level); its would-be pred becomes an FP;
//   - 1..5 points      -> LEVEL_2: counts at L2 always; at L1 it counts
//     (npos AND its matched pred's TP) only if the match happened —
//     UNMATCHED L2 gts are dropped from L1's denominator;
//   - >= 6 points      -> LEVEL_1: counts at both levels.
// [range_lo, range_hi): objects outside the shard are dropped before
// matching (the real tool shards one global match by range; identical
// except when a match would cross a bucket boundary).
static void evaluate_type(
    const std::map<std::pair<std::string, int64_t>, std::vector<const Obj*>>& preds,
    const std::map<std::pair<std::string, int64_t>, std::vector<const Obj*>>& gts,
    const TypeCfg& tc, int level, double* out_ap, double* out_aph,
    double range_lo = -1.0, double range_hi = 1e30) {
  // Per-cutoff accumulators over all frames: the real tool samples the PR
  // curve at 101 fixed score cutoffs 0.00..1.00 ("Cutoffs size: 101" in its
  // stdout; pinned by the tp.015/fp.014 probe in test_waymo_metrics_live.py)
  // and RE-MATCHES the surviving predictions at every cutoff.
  static const int kCuts = 101;
  float cutoff[kCuts];
  for (int k = 0; k < kCuts; k++) cutoff[k] = (float)(k * 0.01);
  std::vector<long> tp(kCuts, 0), fp(kCuts, 0), fn(kCuts, 0);
  std::vector<double> hsum(kCuts, 0.0);

  std::map<std::pair<std::string, int64_t>, char> all_frames;
  for (auto& kv : preds) all_frames[kv.first] = 1;
  for (auto& kv : gts) all_frames[kv.first] = 1;

  for (auto& fr : all_frames) {
    std::vector<const Obj*> p, g;
    auto ip = preds.find(fr.first);
    if (ip != preds.end())
      for (auto* o : ip->second)
        if (o->type == tc.type && box_range(o) >= range_lo &&
            box_range(o) < range_hi)
          p.push_back(o);
    auto ig = gts.find(fr.first);
    if (ig != gts.end())
      for (auto* o : ig->second)
        if (o->type == tc.type && o->num_points > 0 &&
            box_range(o) >= range_lo && box_range(o) < range_hi)
          g.push_back(o);

    const int n = (int)p.size(), m = (int)g.size();
    // Score-descending order: the pred subset at cutoff k is a prefix.
    std::sort(p.begin(), p.end(), [](const Obj* a, const Obj* b) {
      return a->score > b->score;
    });
    std::vector<double> pb(7 * n), gb(7 * m);
    for (int i = 0; i < n; i++) std::memcpy(&pb[7 * i], p[i]->box, 56);
    for (int j = 0; j < m; j++) std::memcpy(&gb[7 * j], g[j]->box, 56);

    // Memoize one matching per distinct prefix length.
    std::map<int, std::vector<int>> match_by_len;  // len -> matched_gt[0..len)
    for (int k = 0; k < kCuts; k++) {
      int len = 0;
      while (len < n && (float)p[len]->score >= cutoff[k]) len++;
      auto it = match_by_len.find(len);
      if (it == match_by_len.end()) {
        std::vector<int> matched_gt(len, -1);
        if (len > 0 && m > 0) {
          std::vector<int> pi(len), gi(len);
          std::vector<double> io(len);
          const int q = hungarian_match_boxes(pb.data(), len, gb.data(), m,
                                              tc.iou, 0, pi.data(), gi.data(),
                                              io.data());
          for (int t = 0; t < q; t++) matched_gt[pi[t]] = gi[t];
        }
        it = match_by_len.emplace(len, std::move(matched_gt)).first;
      }
      const std::vector<int>& matched_gt = it->second;
      std::vector<char> gt_matched(m, 0);
      for (int i = 0; i < len; i++) {
        const int j = matched_gt[i];
        if (j < 0) {
          fp[k]++;
        } else {
          tp[k]++;
          hsum[k] += heading_weight(p[i]->box[6], g[j]->box[6]);
          gt_matched[j] = 1;
        }
      }
      for (int j = 0; j < m; j++) {
        if (gt_matched[j]) continue;
        const bool is_l2 = g[j]->num_points <= 5;
        if (level == 2 || !is_l2) fn[k]++;  // unmatched L2 gts skip L1's FN
      }
    }
  }

  // PR point per cutoff; 0/0 ratios -> 0 (such points sit at r=0 and never
  // move the max-precision envelope).
  const bool dbg = std::getenv("CM3D_PR_DEBUG") != nullptr;
  std::vector<double> prec(kCuts), prec_h(kCuts), rec(kCuts);
  double r_max = 0.0;
  for (int k = 0; k < kCuts; k++) {
    const double denom_p = (double)(tp[k] + fp[k]);
    const double denom_r = (double)(tp[k] + fn[k]);
    prec[k] = denom_p > 0 ? tp[k] / denom_p : 0.0;
    prec_h[k] = denom_p > 0 ? hsum[k] / denom_p : 0.0;
    rec[k] = denom_r > 0 ? tp[k] / denom_r : 0.0;
    r_max = std::max(r_max, rec[k]);
    if (dbg)
      std::fprintf(stderr, "PRDBG %s L%d k=%d tp=%ld fp=%ld fn=%ld r=%.4f p=%.4f\n",
                   tc.name, level, k, tp[k], fp[k], fn[k], rec[k], prec[k]);
  }
  if (r_max == 0.0) { *out_ap = 0; *out_aph = 0; return; }

  // AP = trapezoidal integral over [0, r_max] of the max-precision envelope
  //   P(r) = max{ prec[k] : rec[k] >= r },
  // sampled at the raw recall points PLUS, for each consecutive cutoff pair
  // with a recall gap, points stepping DOWN from the pair's higher recall by
  // the 0.05 desired_recall_delta (r_hi - j*0.05 while > r_lo). The step
  // anchors at r_hi, not an absolute grid: pinned by the probe family in
  // test_waymo_metrics_live.py (plateau 0.841667 -> smear width 0.05;
  // off-grid disc at 1/3 under a (2/3 -> 1/3) gap -> width 1/30 because the
  // insertions land at 2/3 - 6*0.05 = 0.3667; two-disc 0.69375 -> width
  // 0.05 from 0.75 - 4*0.05 = 0.55). mAPH integrates its OWN envelope
  // (probe: mAP 0.561111 / mAPH 0.222222 with a heading-flipped TP).
  std::vector<double> samples;
  for (int k = 0; k < kCuts; k++) samples.push_back(rec[k]);
  for (int k = 0; k + 1 < kCuts; k++) {
    const double r_hi = rec[k], r_lo = rec[k + 1];
    // Epsilon guard: 0.8 - 4*0.05 = 0.6 + 1e-17 in doubles; a spurious
    // sample epsilon above a discontinuity collapses its trapezoid smear.
    for (int j = 1; r_hi - j * 0.05 > r_lo + 1e-9; j++)
      samples.push_back(r_hi - j * 0.05);
  }
  samples.push_back(0.0);
  std::sort(samples.begin(), samples.end());
  samples.erase(std::unique(samples.begin(), samples.end()), samples.end());

  auto envelope = [&](const std::vector<double>& v, double r) {
    double best = 0.0;
    for (int k = 0; k < kCuts; k++)
      if (rec[k] >= r) best = std::max(best, v[k]);
    return best;
  };

  double ap = 0, aph = 0;
  double prev_r = 0, prev_p = envelope(prec, 0.0), prev_ph = envelope(prec_h, 0.0);
  for (double r : samples) {
    if (r <= 0.0) continue;
    if (r > r_max) break;
    const double pe = envelope(prec, r), phe = envelope(prec_h, r);
    ap += (r - prev_r) * 0.5 * (prev_p + pe);
    aph += (r - prev_r) * 0.5 * (prev_ph + phe);
    prev_r = r; prev_p = pe; prev_ph = phe;
  }
  *out_ap = ap;
  *out_aph = aph;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s pred.bin gt.bin\n", argv[0]);
    return 2;
  }
  auto preds = load_bin(argv[1]);
  auto gts = load_bin(argv[2]);

  std::map<std::pair<std::string, int64_t>, std::vector<const Obj*>> pmap, gmap;
  for (auto& o : preds) pmap[{o.context, o.ts}].push_back(&o);
  for (auto& o : gts) gmap[{o.context, o.ts}].push_back(&o);

  // Line inventory and order pinned to the real
  // compute_detection_metrics_main stdout (captured fixture:
  // tests/fixtures/waymo_metrics_real_stdout.txt): all OBJECT_TYPE lines,
  // then RANGE_TYPE lines per type x {[0,30), [30,50), [50,+inf)} x level.
  // (The reference repo's binary also prints debug box dumps before the
  // metric lines; its parser splits on "mAP " so they are inert and not
  // reproduced here.)
  for (const auto& tc : kTypes) {
    for (int level = 1; level <= 2; level++) {
      double ap = 0, aph = 0;
      evaluate_type(pmap, gmap, tc, level, &ap, &aph);
      std::printf("OBJECT_TYPE_TYPE_%s_LEVEL_%d: [mAP %.6g] [mAPH %.6g]\n",
                  tc.name, level, ap, aph);
    }
  }
  struct RangeCfg { double lo, hi; const char* name; };
  static const RangeCfg kRanges[] = {
      {0.0, 30.0, "[0, 30)"},
      {30.0, 50.0, "[30, 50)"},
      {50.0, 1e30, "[50, +inf)"},
  };
  for (const auto& tc : kTypes) {
    for (const auto& rc : kRanges) {
      for (int level = 1; level <= 2; level++) {
        double ap = 0, aph = 0;
        evaluate_type(pmap, gmap, tc, level, &ap, &aph, rc.lo, rc.hi);
        std::printf("RANGE_TYPE_%s_%s_LEVEL_%d: [mAP %.6g] [mAPH %.6g]\n",
                    tc.name, rc.name, level, ap, aph);
      }
    }
  }
  return 0;
}

#endif  // METRICS_MAIN
