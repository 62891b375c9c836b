// Native host-side kernels for pyracecarsimulator_tpu.
//
// The reference implements its EDT, ray-march, and precompute tiers in C++
// behind Cython (SURVEY.md §2c); this library is this framework's native
// tier for the same *host-side* jobs: init-time map compilation (EDT,
// boundary-segment extraction) and the CPU oracle raycaster used as the
// parity/baseline reference. The device hot path is XLA (ops/), not this
// file.
//
// Exposed via a C ABI consumed with ctypes (_native/loader.py). Built by
// csrc/Makefile into pyracecarsimulator_tpu/_native/libracecar_native.so.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr double kBig = 1e20;

// ---------------------------------------------------------------------------
// Felzenszwalb-Huttenlocher exact 1D squared distance transform.
// f: sampled function (kBig where empty), n entries; d: output; v/z: scratch.
void edt_1d(const double* f, double* d, int n, int* v, double* z) {
  int k = 0;
  v[0] = 0;
  z[0] = -kBig;
  z[1] = kBig;
  for (int q = 1; q < n; ++q) {
    double s;
    for (;;) {
      const int vk = v[k];
      s = ((f[q] + static_cast<double>(q) * q) -
           (f[vk] + static_cast<double>(vk) * vk)) /
          (2.0 * q - 2.0 * vk);
      if (s <= z[k] && k > 0) {
        --k;
      } else {
        break;
      }
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = kBig;
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    const int vk = v[k];
    d[q] = (static_cast<double>(q) - vk) * (q - vk) + f[vk];
  }
}

}  // namespace

extern "C" {

// Exact euclidean distance (in cells) to the nearest occupied cell.
// occupied: (h*w) uint8 row-major; out: (h*w) float32.
void rc_edt(const uint8_t* occupied, int h, int w, float* out) {
  std::vector<double> f(static_cast<size_t>(h) * w);
  std::vector<double> d(static_cast<size_t>(h) * w);
  const int n_max = h > w ? h : w;
  std::vector<double> row(n_max), drow(n_max), z(n_max + 1);
  std::vector<int> v(n_max);

  // pass 1: along rows (x)
  for (int i = 0; i < h; ++i) {
    for (int j = 0; j < w; ++j)
      row[j] = occupied[static_cast<size_t>(i) * w + j] ? 0.0 : kBig;
    edt_1d(row.data(), drow.data(), w, v.data(), z.data());
    for (int j = 0; j < w; ++j) f[static_cast<size_t>(i) * w + j] = drow[j];
  }
  // pass 2: along columns (y)
  for (int j = 0; j < w; ++j) {
    for (int i = 0; i < h; ++i) row[i] = f[static_cast<size_t>(i) * w + j];
    edt_1d(row.data(), drow.data(), h, v.data(), z.data());
    for (int i = 0; i < h; ++i)
      d[static_cast<size_t>(i) * w + j] = drow[i];
  }
  for (size_t idx = 0; idx < d.size(); ++idx)
    out[idx] = static_cast<float>(std::sqrt(d[idx]));
}

// Reference CPU oracle ray-march (SURVEY.md §3.3): distance-transform
// sphere trace with nearest-cell sampling, exact reference semantics.
// Returns ranges clamped to max_range. Poses are scan origins.
//   edf: (h*w) float32 meters; bounds (bh, bw) = real (unpadded) dims.
//   xs/ys/cts/sts: per-ray arrays of length n.
void rc_trace_rays(const float* edf, int h, int w, int bh, int bw,
                   double resolution, double ox, double oy,
                   const double* xs, const double* ys, const double* cts,
                   const double* sts, int n, double max_range, double eps,
                   int max_iters, double* out) {
  const double inv_res = 1.0 / resolution;
  for (int r = 0; r < n; ++r) {
    double px = xs[r], py = ys[r];
    const double ct = cts[r], st = sts[r];
    double total = 0.0;
    double result;
    for (int it = 0;; ++it) {
      const double gx = (px - ox) * inv_res;
      const double gy = (py - oy) * inv_res;
      if (gx < 0.0 || gy < 0.0 || gx >= bw || gy >= bh) {
        result = max_range;  // left the (real) map
        break;
      }
      const int ix = static_cast<int>(gx);
      const int iy = static_cast<int>(gy);
      const double d = edf[static_cast<size_t>(iy) * w + ix];
      if (d <= eps || total >= max_range || it >= max_iters) {
        result = total < max_range ? total : max_range;
        break;
      }
      px += d * ct;
      py += d * st;
      total += d;
    }
    out[r] = result;
  }
}

// Exact geometric segment raycast oracle (maps/segments.py semantics).
//   segs: (k, 4) [p, lo, hi, is_vertical] row-major float64.
void rc_raycast_segments(const double* segs, int k, const double* xs,
                         const double* ys, const double* cts,
                         const double* sts, int n, double max_range,
                         double* out) {
  for (int r = 0; r < n; ++r) {
    const double x = xs[r], y = ys[r], ct = cts[r], st = sts[r];
    double best = max_range;
    for (int s = 0; s < k; ++s) {
      const double p = segs[4 * s + 0];
      const double lo = segs[4 * s + 1];
      const double hi = segs[4 * s + 2];
      const bool isv = segs[4 * s + 3] > 0.5;
      const double o_perp = isv ? x : y;
      const double u_perp = isv ? ct : st;
      if (u_perp == 0.0) continue;
      const double t = (p - o_perp) / u_perp;
      if (t < 0.0 || t >= best) continue;
      const double a = (isv ? y : x) + t * (isv ? st : ct);
      if (a >= lo && a <= hi) best = t;
    }
    out[r] = best;
  }
}

// Boundary-segment extraction with collinear merging (maps/segments.py).
// Writes up to max_out segments of [p, lo, hi, is_vertical] (grid units;
// caller scales/offsets); returns the count (or -1 if max_out exceeded).
int rc_extract_segments(const uint8_t* occ, int h, int w, double* out,
                        int max_out) {
  int count = 0;
  auto emit = [&](double p, double lo, double hi, double isv) -> bool {
    if (count >= max_out) return false;
    out[4 * count + 0] = p;
    out[4 * count + 1] = lo;
    out[4 * count + 2] = hi;
    out[4 * count + 3] = isv;
    ++count;
    return true;
  };
  auto at = [&](int i, int j) -> bool {
    if (i < 0 || j < 0 || i >= h || j >= w) return false;
    return occ[static_cast<size_t>(i) * w + j] != 0;
  };
  // vertical boundaries at x = j for j in 0..w: edge where occ changes
  // along x; merge runs over y.
  for (int j = 0; j <= w; ++j) {
    int run_start = -1;
    for (int i = 0; i <= h; ++i) {
      const bool edge = i < h && (at(i, j - 1) != at(i, j));
      if (edge && run_start < 0) run_start = i;
      if (!edge && run_start >= 0) {
        if (!emit(j, run_start, i, 1.0)) return -1;
        run_start = -1;
      }
    }
  }
  // horizontal boundaries at y = i; merge runs over x.
  for (int i = 0; i <= h; ++i) {
    int run_start = -1;
    for (int j = 0; j <= w; ++j) {
      const bool edge = j < w && (at(i - 1, j) != at(i, j));
      if (edge && run_start < 0) run_start = j;
      if (!edge && run_start >= 0) {
        if (!emit(i, run_start, j, 0.0)) return -1;
        run_start = -1;
      }
    }
  }
  return count;
}

// ---------------------------------------------------------------------------
// Sector-cull membership (maps/sectors.py::_membership, native tier).
//
// For each (map tile, angular sector) pair, mark the boundary segments
// conservatively visible from anywhere in the tile in directions within
// the sector, padded by parallax (asin(rt/d)) and the beam-block
// half-width. Same geometry/proof obligation as the NumPy path; double
// precision (the 1e-3 rad safety epsilon dwarfs both f32 and f64
// rounding, so the conservative cover is preserved either way).
//
// segs: (k, 4) doubles [p, lo, hi, is_vertical]; out: (nr*nc*ns, k)
// uint8, row = tile*ns + sector — the exact layout build_sector_map
// consumes. Returns 0 on success.
int rc_sector_membership(const double* segs, int k, int nr, int nc, int ns,
                         double tile_size, double ox, double oy, double rt,
                         double reach, double block_half, uint8_t* out) {
  const double two_pi = 2.0 * M_PI;
  const double wsec = two_pi / ns;
  const int64_t t_n = static_cast<int64_t>(nr) * nc;
  for (int64_t t = 0; t < t_n; ++t) {
    const double cx = ox + (t % nc + 0.5) * tile_size;
    const double cy = oy + (t / nc + 0.5) * tile_size;
    uint8_t* row0 = out + t * ns * k;
    for (int j = 0; j < k; ++j) {
      const double p = segs[4 * j + 0];
      const double lo = segs[4 * j + 1];
      const double hi = segs[4 * j + 2];
      const bool isv = segs[4 * j + 3] > 0.5;
      // endpoints
      const double axp = isv ? p : lo;
      const double ayp = isv ? lo : p;
      const double bxp = isv ? p : hi;
      const double byp = isv ? hi : p;
      // distance from tile center to the segment
      const double along = isv ? cy : cx;
      const double perp = isv ? cx : cy;
      const double d_along =
          std::max(std::max(lo - along, along - hi), 0.0);
      const double d = std::hypot(d_along, std::fabs(perp - p));
      if (d > reach) {
        for (int s = 0; s < ns; ++s) row0[s * k + j] = 0;
        continue;
      }
      // short-way arc between endpoint directions, padded
      const double th1 = std::atan2(ayp - cy, axp - cx);
      const double th2 = std::atan2(byp - cy, bxp - cx);
      double diff = std::fmod(th2 - th1, two_pi);
      if (diff < 0) diff += two_pi;
      const bool flip = diff > M_PI;
      const double arc_lo = flip ? th2 : th1;
      const double width = flip ? two_pi - diff : diff;
      const double par =
          std::asin(std::min(1.0, rt / std::max(d, 1e-9)));
      const double pad = par + block_half + 1e-3;
      const double span = width + 2.0 * pad;
      const bool full = (d <= rt) || (span >= two_pi - wsec);
      const double lo_pad = arc_lo - pad;
      for (int s = 0; s < ns; ++s) {
        double rel = std::fmod(s * wsec - lo_pad, two_pi);
        if (rel < 0) rel += two_pi;
        row0[s * k + j] =
            (full || rel <= span || rel >= two_pi - wsec) ? 1 : 0;
      }
    }
  }
  return 0;
}

}  // extern "C"
