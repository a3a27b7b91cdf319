// Native npy-shard batch loader for the image data pipeline (the PyTorch
// port's copy of the reference's loader, bound by native/loader.py).
//
// The reference's data plane delegates input processing to TensorFlow's C++
// runtime inside the Horovod image (SURVEY.md §2.2); this is the native
// equivalent for the in-repo npy shard format (data/imagefolder.py): header
// parsing + mmap reads + fused normalize/cast ((x - mean)/std then
// f32→bf16 round-to-nearest-even) + a double-buffered prefetch thread, all
// in C++ so the training process's Python threads never contend with the
// GIL for input processing. Exposed via a minimal C ABI consumed with
// ctypes (mpi_operator_tpu_torch/native/loader.py) — no pybind11 dependency.
//
// Build: g++ -O3 -shared -fPIC -pthread npy_loader.cc -o _build/libnpyloader.so

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <random>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Npy {
  void* map = nullptr;
  size_t map_size = 0;
  const uint8_t* data = nullptr;  // past the header
  std::vector<long> shape;
  char kind = 0;                  // 'u' uint, 'f' float, 'i' int
  int itemsize = 0;

  ~Npy() {
    if (map != nullptr && map != MAP_FAILED) munmap(map, map_size);
  }
};

bool parse_npy(const char* path, Npy* out, std::string* err) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) { *err = std::string("cannot open ") + path; return false; }
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); *err = "fstat failed"; return false; }
  void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (m == MAP_FAILED) { *err = std::string("mmap failed: ") + path; return false; }
  out->map = m;
  out->map_size = st.st_size;
  const uint8_t* p = static_cast<const uint8_t*>(m);
  if (st.st_size < 10 || memcmp(p, "\x93NUMPY", 6) != 0) {
    *err = std::string("not an npy file: ") + path;
    return false;
  }
  size_t hlen, hoff;
  if (p[6] == 1) {
    hlen = p[8] | (p[9] << 8);
    hoff = 10;
  } else {
    hlen = p[8] | (p[9] << 8) | (p[10] << 16) | (size_t(p[11]) << 24);
    hoff = 12;
  }
  if (hoff + hlen > size_t(st.st_size)) { *err = "truncated header"; return false; }
  std::string hdr(reinterpret_cast<const char*>(p) + hoff, hlen);

  auto dpos = hdr.find("'descr'");
  if (dpos == std::string::npos) { *err = "no descr"; return false; }
  auto q0 = hdr.find('\'', dpos + 7);
  auto q1 = hdr.find('\'', q0 + 1);
  std::string descr = hdr.substr(q0 + 1, q1 - q0 - 1);   // e.g. "<f4", "|u1"
  if (descr.size() < 3) { *err = "bad descr " + descr; return false; }
  if (descr[0] == '>') { *err = "big-endian npy unsupported"; return false; }
  out->kind = descr[1];
  out->itemsize = atoi(descr.c_str() + 2);
  if (!((out->kind == 'u' && out->itemsize == 1) ||
        (out->kind == 'f' && out->itemsize == 4) ||
        (out->kind == 'i' && (out->itemsize == 4 || out->itemsize == 8)))) {
    *err = "unsupported dtype " + descr + " (want u1, f4, i4 or i8)";
    return false;
  }
  if (hdr.find("'fortran_order': True") != std::string::npos) {
    *err = "fortran-order npy unsupported";
    return false;
  }
  auto spos = hdr.find("'shape'");
  auto l = hdr.find('(', spos);
  auto r = hdr.find(')', l);
  std::string tup = hdr.substr(l + 1, r - l - 1);
  long v = 0;
  bool in_num = false;
  for (char c : tup) {
    if (c >= '0' && c <= '9') { v = v * 10 + (c - '0'); in_num = true; }
    else if (in_num) { out->shape.push_back(v); v = 0; in_num = false; }
  }
  if (in_num) out->shape.push_back(v);
  out->data = p + hoff + hlen;
  size_t n = out->itemsize;
  for (long s : out->shape) n *= s;
  if (hoff + hlen + n > size_t(st.st_size)) { *err = "truncated data"; return false; }
  return true;
}

static inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  memcpy(&x, &f, 4);
  x += 0x7FFF + ((x >> 16) & 1);   // round to nearest even
  return uint16_t(x >> 16);
}

struct Loader {
  std::vector<Npy> imgs, lbls;
  long batch = 0, rows_per_img = 0;
  int channels = 3;
  int out_bf16 = 0;
  float mean[3], stdv[3];
  std::mt19937 rng;

  size_t img_out_bytes = 0;        // per batch
  // double-buffered prefetch
  std::vector<uint8_t> buf_img[2];
  std::vector<int32_t> buf_lbl[2];
  int filled[2] = {0, 0};
  int next_fill = 0, next_read = 0;
  int waiters = 0;            // consumers inside nsl_next (close() waits)
  bool stop = false;
  std::string error;
  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;

  // epoch iteration state (worker thread only)
  std::vector<int> order;
  size_t order_pos = 0;
  long row = 0;

  void advance_shard() {
    if (order_pos + 1 < order.size()) {
      ++order_pos;
    } else {
      std::shuffle(order.begin(), order.end(), rng);
      order_pos = 0;
    }
    row = 0;
  }

  // fill one batch into slot s; returns false on error
  bool produce(int s) {
    // find a shard position with a full batch remaining
    for (int guard = 0; ; ++guard) {
      if (guard > int(order.size()) + 1) {
        error = "no shard can produce a full batch";
        return false;
      }
      const Npy& im = imgs[order[order_pos]];
      long usable = im.shape[0] - im.shape[0] % batch;
      if (row + batch <= usable) break;
      advance_shard();
    }
    const Npy& im = imgs[order[order_pos]];
    const Npy& lb = lbls[order[order_pos]];
    const long pixels = rows_per_img;             // per image, H*W*C
    uint8_t* dst = buf_img[s].data();
    for (long b = 0; b < batch; ++b) {
      const long src_row = row + b;
      float* f32dst = reinterpret_cast<float*>(dst) + b * pixels;
      uint16_t* bfdst = reinterpret_cast<uint16_t*>(dst) + b * pixels;
      if (im.kind == 'u') {
        const uint8_t* src = im.data + size_t(src_row) * pixels;
        for (long i = 0; i < pixels; ++i) {
          const int c = i % channels;
          const float v = (float(src[i]) - mean[c]) / stdv[c];
          if (out_bf16) bfdst[i] = f32_to_bf16(v);
          else f32dst[i] = v;
        }
      } else {                                    // f4
        const float* src = reinterpret_cast<const float*>(im.data)
            + size_t(src_row) * pixels;
        for (long i = 0; i < pixels; ++i) {
          const int c = i % channels;
          const float v = (src[i] - mean[c]) / stdv[c];
          if (out_bf16) bfdst[i] = f32_to_bf16(v);
          else f32dst[i] = v;
        }
      }
      if (lb.kind == 'i' && lb.itemsize == 8) {
        buf_lbl[s][b] = int32_t(
            reinterpret_cast<const int64_t*>(lb.data)[src_row]);
      } else if (lb.kind == 'i') {
        buf_lbl[s][b] = reinterpret_cast<const int32_t*>(lb.data)[src_row];
      } else {
        buf_lbl[s][b] = int32_t(lb.data[src_row]);
      }
    }
    row += batch;
    return true;
  }

  void run() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv.wait(lk, [&] { return stop || !filled[next_fill]; });
      if (stop) return;
      const int s = next_fill;
      lk.unlock();
      const bool ok = produce(s);               // heavy work, lock-free
      lk.lock();
      if (!ok) { stop = true; cv.notify_all(); return; }
      filled[s] = 1;
      next_fill = 1 - s;
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Returns an opaque handle, or nullptr with *err_out filled (err_cap bytes).
void* nsl_open(const char** img_paths, const char** lbl_paths, int n_shards,
               long batch, int height, int width, int channels,
               int out_bf16, unsigned seed,
               const float* mean, const float* stdv,
               char* err_out, int err_cap) {
  auto fail = [&](const std::string& e) -> void* {
    snprintf(err_out, err_cap, "%s", e.c_str());
    return nullptr;
  };
  if (n_shards <= 0) return fail("no shards");
  auto* L = new Loader();
  std::string err;
  for (int i = 0; i < n_shards; ++i) {
    L->imgs.emplace_back();
    L->lbls.emplace_back();
    if (!parse_npy(img_paths[i], &L->imgs.back(), &err) ||
        !parse_npy(lbl_paths[i], &L->lbls.back(), &err)) {
      delete L;
      return fail(err);
    }
    const Npy& im = L->imgs.back();
    const Npy& lb = L->lbls.back();
    // roles have distinct dtype contracts: reinterpreting an int image
    // shard as float (or vice versa) would be silent garbage
    if (!(im.kind == 'u' || (im.kind == 'f' && im.itemsize == 4))) {
      delete L;
      return fail(std::string("image shard must be u1 or f4: ")
                  + img_paths[i]);
    }
    if (lb.kind == 'f') {
      delete L;
      return fail(std::string("label shard must be integer: ")
                  + lbl_paths[i]);
    }
    if (im.shape.size() != 4) { delete L; return fail("images must be [N,H,W,C]"); }
    // the caller sized its destination buffer from (height, width,
    // channels); a mismatched shard would overflow nsl_next's memcpy
    if (im.shape[1] != height || im.shape[2] != width ||
        im.shape[3] != channels) {
      delete L;
      return fail(std::string("shard ") + img_paths[i] +
                  " shape does not match requested HxWxC");
    }
    if (lb.shape.size() != 1 || lb.shape[0] != im.shape[0]) {
      delete L;
      return fail("labels must be [N] matching images");
    }
    long rows = im.shape[1] * im.shape[2] * im.shape[3];
    if (i == 0) L->rows_per_img = rows;
    else if (rows != L->rows_per_img) { delete L; return fail("shard shape mismatch"); }
  }
  L->batch = batch;
  L->channels = channels;
  L->out_bf16 = out_bf16;
  L->rng.seed(seed);
  for (int c = 0; c < 3; ++c) { L->mean[c] = mean[c]; L->stdv[c] = stdv[c]; }
  L->img_out_bytes = size_t(batch) * L->rows_per_img * (out_bf16 ? 2 : 4);
  for (int s = 0; s < 2; ++s) {
    L->buf_img[s].resize(L->img_out_bytes);
    L->buf_lbl[s].resize(batch);
  }
  L->order.resize(n_shards);
  for (int i = 0; i < n_shards; ++i) L->order[i] = i;
  std::shuffle(L->order.begin(), L->order.end(), L->rng);
  L->worker = std::thread([L] { L->run(); });
  return L;
}

// Copies the next batch into caller buffers. Returns 0 on success, -1 on
// loader failure (message in err_out).
int nsl_next(void* handle, void* img_out, int32_t* lbl_out,
             char* err_out, int err_cap) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  ++L->waiters;
  L->cv.wait(lk, [&] { return L->stop || L->filled[L->next_read]; });
  if (L->stop) {
    snprintf(err_out, err_cap, "%s", L->error.empty()
             ? "loader stopped" : L->error.c_str());
    --L->waiters;
    L->cv.notify_all();
    return -1;
  }
  const int s = L->next_read;
  lk.unlock();
  memcpy(img_out, L->buf_img[s].data(), L->img_out_bytes);
  memcpy(lbl_out, L->buf_lbl[s].data(), L->batch * sizeof(int32_t));
  lk.lock();
  L->filled[s] = 0;
  L->next_read = 1 - s;
  --L->waiters;
  L->cv.notify_all();
  return 0;
}

void nsl_close(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    // wake any consumer stuck in nsl_next and wait for it to LEAVE the
    // Loader before freeing — deleting under a live waiter is a
    // use-after-free
    std::unique_lock<std::mutex> lk(L->mu);
    L->stop = true;
    L->cv.notify_all();
    L->cv.wait(lk, [&] { return L->waiters == 0; });
  }
  L->cv.notify_all();
  if (L->worker.joinable()) L->worker.join();
  delete L;
}

}  // extern "C"
