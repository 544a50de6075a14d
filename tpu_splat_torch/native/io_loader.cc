// Native dataset IO: PNG decode + box downscale + threaded ordered prefetch.
//
// TPU-side role of the reference's native data path: the reference leans on
// CUDA-side tensors + PIL (scene/dataset_readers.py, utils/camera_utils.py);
// here the host is the bottleneck (TPU VMs spend train-loop time decoding
// images), so decode runs in a C++ thread pool ahead of the training loop.
//
// PNG support: 8-bit, non-interlaced, color types 0 (gray), 2 (RGB),
// 4 (gray+alpha), 6 (RGBA) — what COLMAP/Blender datasets contain. Decode is
// implemented from the PNG spec (chunk parse -> zlib inflate -> per-row
// unfilter) on top of the system zlib; no external image library.
//
// C ABI (ctypes-friendly), see tpu_splat_torch/data/native_loader.py:
//   tsio_decode_png(path, divisor, &w, &h, &c, &data) -> 0/err
//   tsio_open(paths, n, divisor, threads) -> handle
//   tsio_next(handle, &idx, &w, &h, &c, &data) -> 0 ok / 1 done
//   tsio_free(data); tsio_close(handle)

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> data;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(n);
  bool ok = fread(out->data(), 1, n, f) == size_t(n);
  fclose(f);
  return ok;
}

int paeth(int a, int b, int c) {
  int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// -> 0 ok, negative error codes
int decode_png(const std::vector<uint8_t>& buf, Image* img) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (buf.size() < 8 || memcmp(buf.data(), sig, 8) != 0) return -1;

  size_t pos = 8;
  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    if (pos + 12 + len > buf.size()) return -2;
    const char* type = reinterpret_cast<const char*>(&buf[pos + 4]);
    const uint8_t* data = &buf[pos + 8];
    if (memcmp(type, "IHDR", 4) == 0) {
      w = be32(data);
      h = be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (w == 0 || h == 0 || bit_depth != 8 || interlace != 0) return -3;
  int c;
  switch (color_type) {
    case 0: c = 1; break;
    case 2: c = 3; break;
    case 4: c = 2; break;
    case 6: c = 4; break;
    default: return -4;  // palette not supported
  }

  size_t stride = size_t(w) * c;
  std::vector<uint8_t> raw((stride + 1) * h);
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return -5;
  zs.next_in = idat.data();
  zs.avail_in = idat.size();
  zs.next_out = raw.data();
  zs.avail_out = raw.size();
  int zr = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (zr != Z_STREAM_END || zs.avail_out != 0) return -6;

  img->w = w;
  img->h = h;
  img->c = c;
  img->data.resize(stride * h);
  uint8_t* prev = nullptr;
  for (uint32_t y = 0; y < h; y++) {
    const uint8_t* src = &raw[(stride + 1) * y];
    uint8_t filter = src[0];
    src++;
    uint8_t* dst = &img->data[stride * y];
    for (size_t x = 0; x < stride; x++) {
      int a = x >= size_t(c) ? dst[x - c] : 0;
      int b = prev ? prev[x] : 0;
      int cc = (prev && x >= size_t(c)) ? prev[x - c] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, cc); break;
        default: return -7;
      }
      dst[x] = uint8_t(v);
    }
    prev = dst;
  }
  return 0;
}

// integer box downscale by `div` (the reference's resolution divisors
// {2,4,8}, utils/camera_utils.py:19-44)
void downscale(const Image& in, int div, Image* out) {
  out->w = in.w / div;
  out->h = in.h / div;
  out->c = in.c;
  out->data.resize(size_t(out->w) * out->h * out->c);
  for (int y = 0; y < out->h; y++) {
    for (int x = 0; x < out->w; x++) {
      for (int ch = 0; ch < in.c; ch++) {
        uint32_t acc = 0;
        for (int dy = 0; dy < div; dy++) {
          const uint8_t* row = &in.data[(size_t(y) * div + dy) * in.w * in.c];
          for (int dx = 0; dx < div; dx++)
            acc += row[(size_t(x) * div + dx) * in.c + ch];
        }
        out->data[(size_t(y) * out->w + x) * out->c + ch] =
            uint8_t(acc / (div * div));
      }
    }
  }
}

int load_image(const std::string& path, int divisor, Image* img) {
  std::vector<uint8_t> buf;
  if (!read_file(path.c_str(), &buf)) return -10;
  Image full;
  int rc = decode_png(buf, &full);
  if (rc != 0) return rc;
  if (divisor > 1) {
    downscale(full, divisor, img);
  } else {
    *img = std::move(full);
  }
  return 0;
}

struct Loader {
  std::vector<std::string> paths;
  int divisor = 1;
  std::atomic<size_t> next_job{0};
  size_t next_out = 0;
  std::map<size_t, Image> ready;   // decoded, waiting for ordered delivery
  std::map<size_t, int> errors;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
  size_t max_ahead = 16;  // bound memory: stay <= this far ahead of consumer
  bool closing = false;

  void work() {
    for (;;) {
      size_t i = next_job.fetch_add(1);
      if (i >= paths.size()) return;
      {
        // backpressure: don't run far ahead of the consumer
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return closing || i < next_out + max_ahead; });
        if (closing) return;
      }
      Image img;
      int rc = load_image(paths[i], divisor, &img);
      std::lock_guard<std::mutex> lk(mu);
      if (rc == 0)
        ready.emplace(i, std::move(img));
      else
        errors[i] = rc;
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int tsio_decode_png(const char* path, int divisor, int* w, int* h, int* c,
                    uint8_t** data) {
  Image img;
  int rc = load_image(path, divisor, &img);
  if (rc != 0) return rc;
  *w = img.w;
  *h = img.h;
  *c = img.c;
  *data = static_cast<uint8_t*>(malloc(img.data.size()));
  memcpy(*data, img.data.data(), img.data.size());
  return 0;
}

void tsio_free(uint8_t* data) { free(data); }

void* tsio_open(const char** paths, int n, int divisor, int threads) {
  Loader* L = new Loader();
  for (int i = 0; i < n; i++) L->paths.emplace_back(paths[i]);
  L->divisor = divisor;
  if (threads <= 0) threads = 2;
  for (int t = 0; t < threads; t++)
    L->workers.emplace_back([L] { L->work(); });
  return L;
}

// ordered delivery: blocks until image #k (k = consumer position) is decoded.
// returns 0 ok, 1 = exhausted, <0 = decode error for that index
int tsio_next(void* handle, int* idx, int* w, int* h, int* c, uint8_t** data) {
  Loader* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_out >= L->paths.size()) return 1;
  size_t want = L->next_out;
  L->cv.wait(lk, [&] {
    return L->ready.count(want) || L->errors.count(want);
  });
  *idx = int(want);
  L->next_out++;
  L->cv.notify_all();  // release backpressure
  auto it = L->ready.find(want);
  if (it == L->ready.end()) {
    int rc = L->errors[want];
    L->errors.erase(want);
    return rc;
  }
  Image img = std::move(it->second);
  L->ready.erase(it);
  lk.unlock();
  *w = img.w;
  *h = img.h;
  *c = img.c;
  *data = static_cast<uint8_t*>(malloc(img.data.size()));
  memcpy(*data, img.data.data(), img.data.size());
  return 0;
}

void tsio_close(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->closing = true;
    L->next_job.store(L->paths.size());
    L->cv.notify_all();
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
