// Native host data-path kernels for the CLOUDSC JAX framework.
//
// The reference implements its host-side data path natively: the OpenMP-
// parallel column expansion (ref: src/common/module/expand_mod.F90:173-334,
// C twin src/cloudsc_c/cloudsc/load_state.c) and the validation statistics
// (ref: src/cloudsc_c/cloudsc/cloudsc_validate.c:20-153). The compute path
// runs on the device, but these host-side stages sit on the critical path of
// every benchmark run (tiling 100 file columns out to ~10^5..10^6 benchmark
// columns touches gigabytes) — so they are native here too, threaded with
// std::thread (the OpenMP analogue), exposed through a C ABI for ctypes.
//
// Build: make -C cloudsc_tpu/native  (or the lazy g++ build in __init__.py)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int resolve_threads(int nthreads) {
  if (nthreads > 0) return nthreads;
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? static_cast<int>(hw) : 4;
}

// Run fn(t) on nthreads workers (fn(0) inline on the caller's thread).
template <typename F>
void parallel_for_threads(int nthreads, F fn) {
  std::vector<std::thread> pool;
  pool.reserve(nthreads - 1);
  for (int t = 1; t < nthreads; ++t) pool.emplace_back(fn, t);
  fn(0);
  for (auto& th : pool) th.join();
}

// Cyclically tile the trailing axis of src (nrows, klon) into dst
// (nrows, ngptot): dst[r, j] = src[r, j % klon]  (ref: expand_mod.F90:237-334)
template <typename T>
void expand_rows(const T* src, T* dst, int64_t nrows, int64_t klon,
                 int64_t ngptot, int nthreads) {
  nthreads = std::min<int64_t>(resolve_threads(nthreads), std::max<int64_t>(nrows, 1));
  parallel_for_threads(static_cast<int>(nthreads), [=](int t) {
    int64_t lo = nrows * t / nthreads;
    int64_t hi = nrows * (t + 1) / nthreads;
    for (int64_t r = lo; r < hi; ++r) {
      const T* s = src + r * klon;
      T* d = dst + r * ngptot;
      int64_t full = ngptot / klon;
      for (int64_t rep = 0; rep < full; ++rep)
        std::memcpy(d + rep * klon, s, sizeof(T) * klon);
      int64_t tail = ngptot - full * klon;
      if (tail) std::memcpy(d + full * klon, s, sizeof(T) * tail);
    }
  });
}

// Grouped-layout tile of the trailing axis: all copies of source column g
// are written contiguously, group g spanning [off_g, off_g + count_g) with
// count_g = ceil((ngptot - g) / klon) — a column permutation of the cyclic
// expansion (see expand.group_counts / group_inverse).
template <typename T>
void expand_rows_grouped(const T* src, T* dst, int64_t nrows, int64_t klon,
                         int64_t ngptot, int nthreads) {
  nthreads = std::min<int64_t>(resolve_threads(nthreads), std::max<int64_t>(nrows, 1));
  parallel_for_threads(static_cast<int>(nthreads), [=](int t) {
    int64_t lo = nrows * t / nthreads;
    int64_t hi = nrows * (t + 1) / nthreads;
    for (int64_t r = lo; r < hi; ++r) {
      const T* s = src + r * klon;
      T* d = dst + r * ngptot;
      int64_t off = 0;
      for (int64_t g = 0; g < klon && off < ngptot; ++g) {
        int64_t cnt = (ngptot - g + klon - 1) / klon;
        std::fill(d + off, d + off + cnt, s[g]);
        off += cnt;
      }
    }
  });
}

// Single-pass validation statistics over one field vs its reference:
// min, max, max|err|, sum|err|, sum|ref|  (ref: validate_mod.F90:263-296)
template <typename T>
void field_stats(const T* field, const T* ref, int64_t n, int nthreads,
                 double* out5) {
  nthreads = resolve_threads(nthreads);
  int64_t chunk = (n + nthreads - 1) / nthreads;
  std::vector<double> mins(nthreads, HUGE_VAL), maxs(nthreads, -HUGE_VAL),
      maxerrs(nthreads, 0.0), errsums(nthreads, 0.0), refsums(nthreads, 0.0);
  parallel_for_threads(nthreads, [&](int t) {
    int64_t lo = std::min<int64_t>(t * chunk, n);
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    double mn = HUGE_VAL, mx = -HUGE_VAL, me = 0.0, es = 0.0, rs = 0.0;
    for (int64_t i = lo; i < hi; ++i) {
      double f = static_cast<double>(field[i]);
      double r = static_cast<double>(ref[i]);
      double e = std::fabs(f - r);
      mn = std::min(mn, f);
      mx = std::max(mx, f);
      me = std::max(me, e);
      es += e;
      rs += std::fabs(r);
    }
    mins[t] = mn; maxs[t] = mx; maxerrs[t] = me;
    errsums[t] = es; refsums[t] = rs;
  });
  double mn = HUGE_VAL, mx = -HUGE_VAL, me = 0.0, es = 0.0, rs = 0.0;
  for (int t = 0; t < nthreads; ++t) {  // deterministic ordered reduce
    mn = std::min(mn, mins[t]);
    mx = std::max(mx, maxs[t]);
    me = std::max(me, maxerrs[t]);
    es += errsums[t];
    rs += refsums[t];
  }
  out5[0] = mn; out5[1] = mx; out5[2] = me; out5[3] = es; out5[4] = rs;
}

}  // namespace

extern "C" {

void cs_expand_f64(const double* src, double* dst, int64_t nrows,
                   int64_t klon, int64_t ngptot, int nthreads) {
  expand_rows(src, dst, nrows, klon, ngptot, nthreads);
}
void cs_expand_f32(const float* src, float* dst, int64_t nrows, int64_t klon,
                   int64_t ngptot, int nthreads) {
  expand_rows(src, dst, nrows, klon, ngptot, nthreads);
}
void cs_expand_i32(const int32_t* src, int32_t* dst, int64_t nrows,
                   int64_t klon, int64_t ngptot, int nthreads) {
  expand_rows(src, dst, nrows, klon, ngptot, nthreads);
}
void cs_expand_u8(const uint8_t* src, uint8_t* dst, int64_t nrows,
                  int64_t klon, int64_t ngptot, int nthreads) {
  expand_rows(src, dst, nrows, klon, ngptot, nthreads);
}

void cs_expand_grouped_f64(const double* src, double* dst, int64_t nrows,
                           int64_t klon, int64_t ngptot, int nthreads) {
  expand_rows_grouped(src, dst, nrows, klon, ngptot, nthreads);
}
void cs_expand_grouped_f32(const float* src, float* dst, int64_t nrows,
                           int64_t klon, int64_t ngptot, int nthreads) {
  expand_rows_grouped(src, dst, nrows, klon, ngptot, nthreads);
}
void cs_expand_grouped_i32(const int32_t* src, int32_t* dst, int64_t nrows,
                           int64_t klon, int64_t ngptot, int nthreads) {
  expand_rows_grouped(src, dst, nrows, klon, ngptot, nthreads);
}
void cs_expand_grouped_u8(const uint8_t* src, uint8_t* dst, int64_t nrows,
                          int64_t klon, int64_t ngptot, int nthreads) {
  expand_rows_grouped(src, dst, nrows, klon, ngptot, nthreads);
}

void cs_field_stats_f64(const double* field, const double* ref, int64_t n,
                        int nthreads, double* out5) {
  field_stats(field, ref, n, nthreads, out5);
}
void cs_field_stats_f32(const float* field, const float* ref, int64_t n,
                        int nthreads, double* out5) {
  field_stats(field, ref, n, nthreads, out5);
}

int cs_hardware_threads() {
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? static_cast<int>(hw) : 0;
}

}  // extern "C"
