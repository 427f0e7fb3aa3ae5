// Host writers of the port's cloud files: .patch, .ply and .pset.
//
// Each function formats a whole file into one buffer and writes the
// header and the rows in order. The rows are split into contiguous
// ranges, a thread for each kRowsPerThread rows and at most kMaxThreads,
// each range formatted at its own offset of the buffer. The bytes are
// those of the JAX package's Python writers (io/patches.write_patch_file,
// io/patches.write_pset and io/ply.write_patch_ply with
// force_python=True):
//   .patch  "PATCHES\n<P>\n", then a patch:
//           "PATCHS\n", coord and normal (4 values a line), ncc dscale
//           ascale, each at %.17g; each id list as its count of
//           non-negative ids, a newline, those ids joined by single
//           spaces and " \n"; a blank line;
//   .ply    the header it is given, then x y z nx ny nz at %.9g, the
//           colour's three integers, quality at %.9g;
//   .pset   x y z nx ny nz at %.9g.
//
// Floats go through std::to_chars with chars_format::general and a
// precision, which C++17 defines as printf's %.*g in the C locale: what
// Python's "%.17g" and "%.9g" give, but for a NaN with its sign bit set,
// which printf and to_chars write as "-nan" and Python as "nan".
//
// io/writers.py compiles this file with the host C++ compiler at first use
// and binds it with ctypes. Every function returns 0, or an errno value
// (ENOMEM where the buffer cannot be allocated).

#include <algorithm>
#include <cerrno>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <new>
#include <system_error>
#include <thread>
#include <vector>

namespace {

// Room for one value and the character after it: "%.17g" writes at most
// 24 characters ("-2.2250738585072014e-308"), an int64 at most 20.
constexpr size_t kFloat = 25;
constexpr size_t kInt = 21;
// Below this many rows a thread costs more than it saves.
constexpr int64_t kRowsPerThread = 8192;
constexpr int64_t kMaxThreads = 8;

char *put(char *p, const char *s, size_t n) {
  std::memcpy(p, s, n);
  return p + n;
}

// x as Python's "%.<prec>g" writes it.
char *put_float(char *p, double x, int prec) {
  if (std::isnan(x)) return put(p, "nan", 3);
  return std::to_chars(p, p + kFloat, x, std::chars_format::general, prec)
      .ptr;
}

char *put_int(char *p, int64_t v) { return std::to_chars(p, p + kInt, v).ptr; }

// `n` floats of `row` at `prec`, each followed by its character of `sep`.
char *put_floats(char *p, const double *row, const char *sep, int n,
                 int prec) {
  for (int j = 0; j < n; ++j) {
    p = put_float(p, row[j], prec);
    *p++ = sep[j];
  }
  return p;
}

// One id list of a patch: the count of its non-negative ids, a newline,
// those ids joined by single spaces, then " \n".
char *put_ids(char *p, const int64_t *ids, int64_t k) {
  int64_t n = 0;
  for (int64_t j = 0; j < k; ++j) n += ids[j] >= 0;
  p = put_int(p, n);
  *p++ = '\n';
  bool first = true;
  for (int64_t j = 0; j < k; ++j) {
    if (ids[j] < 0) continue;
    if (!first) *p++ = ' ';
    p = put_int(p, ids[j]);
    first = false;
  }
  return put(p, " \n", 2);
}

// Formats rows [0, rows) with `row(p, i)`, which writes row i at p and
// returns its end (at most row_max bytes), and writes `head` then the rows
// to `path`.
template <class Row>
int format_and_save(const char *path, const char *head, size_t head_len,
                    int64_t rows, size_t row_max, const Row &row) {
  const int64_t threads =
      std::max<int64_t>(1, std::min(rows / kRowsPerThread, kMaxThreads));
  std::unique_ptr<char[]> buf(new (std::nothrow) char[rows * row_max + 1]);
  if (!buf) return ENOMEM;
  std::vector<char *> begin(threads), end(threads);
  auto work = [&](int64_t t) {
    const int64_t r0 = rows * t / threads, r1 = rows * (t + 1) / threads;
    char *p = begin[t] = buf.get() + r0 * row_max;
    for (int64_t i = r0; i < r1; ++i) p = row(p, i);
    end[t] = p;
  };
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < threads; ++t) {
    try {
      pool.emplace_back(work, t);
    } catch (const std::system_error &) {
      work(t);
    }
  }
  work(0);
  for (auto &th : pool) th.join();

  std::FILE *f = std::fopen(path, "wb");
  if (!f) return errno ? errno : EIO;
  bool ok = std::fwrite(head, 1, head_len, f) == head_len;
  for (int64_t t = 0; t < threads && ok; ++t) {
    const size_t n = end[t] - begin[t];
    ok = std::fwrite(begin[t], 1, n, f) == n;
  }
  int err = ok ? 0 : (errno ? errno : EIO);
  if (std::fclose(f) != 0 && !err) err = errno ? errno : EIO;
  return err;
}

}  // namespace

extern "C" {

// heads: float64 [rows, 11] (coord x y z w, normal x y z w, ncc, dscale,
// ascale); images [rows, k_images] and vimages [rows, k_vimages]: int64
// ids, padded with negative values.
int cmvs_write_patch(const char *path, const double *heads,
                     const int64_t *images, int64_t k_images,
                     const int64_t *vimages, int64_t k_vimages,
                     int64_t rows) {
  static const char kSep[11] = {' ', ' ', ' ', '\n', ' ', ' ',
                                ' ', '\n', ' ', ' ', '\n'};
  char head[8 + kInt + 1];
  char *h = put(head, "PATCHES\n", 8);
  h = put_int(h, rows);
  *h++ = '\n';
  return format_and_save(
      path, head, h - head, rows,
      7 + 11 * kFloat + 2 * (kInt + 2) + (k_images + k_vimages) * kInt + 1,
      [=](char *p, int64_t i) {
        p = put(p, "PATCHS\n", 7);
        p = put_floats(p, heads + 11 * i, kSep, 11, 17);
        p = put_ids(p, images + k_images * i, k_images);
        p = put_ids(p, vimages + k_vimages * i, k_vimages);
        *p++ = '\n';
        return p;
      });
}

// header: the file's header, NUL-terminated; xyzn: float64 [rows, 6]
// (x y z nx ny nz); colors: int64 [rows, 3]; quality: float64 [rows].
int cmvs_write_ply(const char *path, const char *header, const double *xyzn,
                   const int64_t *colors, const double *quality,
                   int64_t rows) {
  static const char kSep[6] = {' ', ' ', ' ', ' ', ' ', ' '};
  return format_and_save(
      path, header, std::strlen(header), rows, 7 * kFloat + 3 * kInt,
      [=](char *p, int64_t i) {
        p = put_floats(p, xyzn + 6 * i, kSep, 6, 9);
        for (int j = 0; j < 3; ++j) {
          p = put_int(p, colors[3 * i + j]);
          *p++ = ' ';
        }
        p = put_float(p, quality[i], 9);
        *p++ = '\n';
        return p;
      });
}

// xyzn: float64 [rows, 6] (x y z nx ny nz).
int cmvs_write_pset(const char *path, const double *xyzn, int64_t rows) {
  static const char kSep[6] = {' ', ' ', ' ', ' ', ' ', '\n'};
  return format_and_save(path, "", 0, rows, 6 * kFloat,
                         [=](char *p, int64_t i) {
                           return put_floats(p, xyzn + 6 * i, kSep, 6, 9);
                         });
}

}  // extern "C"
