// Native streaming frame loader for pbmm_tpu.
//
// The reference's "runtime" is Unity's player loop handing RenderTextures to
// the effect (`OnRenderImage`, MotionMagnificationProcessor.cs:101); this
// framework's analog is a host-side streaming reader that keeps the device
// fed: a background prefetch thread reads + converts the next chunk of
// frames (uint8 -> f32 [0,1]) into a ring of pinned host buffers while the
// previous chunk is being magnified on the device.
//
// Supports .npy (THWC, dtype |u1 or <f4, C-order) via a minimal header
// parser; exposed through a C API consumed with ctypes
// (pbmm_tpu/native/__init__.py).  Build: see pbmm_tpu/native/__init__.py
// (g++ -O3 -shared -fPIC).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  long t = 0, h = 0, w = 0, c = 0;
  int dtype = 0;  // 0 = u8, 1 = f32
  long header_bytes = 0;
};

bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  unsigned int hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    hlen = b[0] | (b[1] << 8);
    info->header_bytes = 10 + hlen;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | ((unsigned)b[3] << 24);
    info->header_bytes = 12 + hlen;
  }
  std::string hdr(hlen, '\0');
  if (fread(&hdr[0], 1, hlen, f) != hlen) return false;

  if (hdr.find("'fortran_order': False") == std::string::npos) return false;
  if (hdr.find("'<f4'") != std::string::npos) {
    info->dtype = 1;
  } else if (hdr.find("'|u1'") != std::string::npos) {
    info->dtype = 0;
  } else {
    return false;
  }
  size_t sp = hdr.find("'shape': (");
  if (sp == std::string::npos) return false;
  long dims[4] = {0, 0, 0, 0};
  int n = sscanf(hdr.c_str() + sp + 10, "%ld, %ld, %ld, %ld", &dims[0],
                 &dims[1], &dims[2], &dims[3]);
  if (n != 4) return false;
  info->t = dims[0];
  info->h = dims[1];
  info->w = dims[2];
  info->c = dims[3];
  return info->c == 3 && info->t > 0;
}

struct Loader {
  FILE* f = nullptr;
  NpyInfo info;
  long chunk_frames = 0;
  long next_read_frame = 0;   // producer position
  long next_serve_frame = 0;  // consumer position

  // Ring of 2 prefetched chunks.
  struct Slot {
    std::vector<float> data;
    long first_frame = -1;
    long n_frames = 0;
    bool ready = false;
  };
  Slot slots[2];
  int serve_slot = 0;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<bool> stop{false};

  long frame_elems() const { return info.h * info.w * info.c; }

  void read_chunk_into(Slot* s, long first) {
    long n = std::min(chunk_frames, info.t - first);
    s->first_frame = first;
    s->n_frames = n;
    if (n <= 0) return;
    long elems = n * frame_elems();
    s->data.resize(chunk_frames * frame_elems());
    long byte_per = info.dtype == 1 ? 4 : 1;
    long offset = info.header_bytes + first * frame_elems() * byte_per;
#ifdef _WIN32
    fseek(f, offset, SEEK_SET);
#else
    fseeko(f, offset, SEEK_SET);
#endif
    if (info.dtype == 1) {
      size_t got = fread(s->data.data(), 4, elems, f);
      (void)got;
    } else {
      std::vector<uint8_t> raw(elems);
      size_t got = fread(raw.data(), 1, elems, f);
      (void)got;
      const float k = 1.0f / 255.0f;
      float* out = s->data.data();
      // Vectorizable tight loop (u8 -> f32 normalize).
      for (long i = 0; i < elems; ++i) out[i] = raw[i] * k;
    }
  }

  void run() {
    int fill = 0;
    while (true) {
      std::unique_lock<std::mutex> lk(mu);
      cv_free.wait(lk, [&] { return stop.load() || !slots[fill].ready; });
      if (stop.load()) return;
      long first = next_read_frame;
      if (first >= info.t) return;  // EOF: nothing more to produce
      lk.unlock();

      read_chunk_into(&slots[fill], first);

      lk.lock();
      next_read_frame = first + slots[fill].n_frames;
      slots[fill].ready = true;
      cv_ready.notify_all();
      fill = 1 - fill;
    }
  }
};

}  // namespace

extern "C" {

void* fl_open(const char* path, long chunk_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* ld = new Loader();
  ld->f = f;
  if (!parse_npy_header(f, &ld->info)) {
    fclose(f);
    delete ld;
    return nullptr;
  }
  ld->chunk_frames = chunk_frames > 0 ? chunk_frames : 8;
  ld->worker = std::thread([ld] { ld->run(); });
  return ld;
}

int fl_info(void* h, long* t, long* hh, long* w, long* c, int* dtype) {
  if (!h) return -1;
  auto* ld = static_cast<Loader*>(h);
  *t = ld->info.t;
  *hh = ld->info.h;
  *w = ld->info.w;
  *c = ld->info.c;
  *dtype = ld->info.dtype;
  return 0;
}

// Copies the next prefetched chunk into out (f32, [chunk][H][W][C]).
// Returns number of frames delivered, 0 at EOF, <0 on error.
long fl_next(void* h, float* out) {
  if (!h) return -1;
  auto* ld = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(ld->mu);
  if (ld->next_serve_frame >= ld->info.t) return 0;
  auto* slot = &ld->slots[ld->serve_slot];
  ld->cv_ready.wait(lk, [&] { return slot->ready; });
  long n = slot->n_frames;
  memcpy(out, slot->data.data(),
         sizeof(float) * n * ld->frame_elems());
  ld->next_serve_frame = slot->first_frame + n;
  slot->ready = false;
  ld->serve_slot = 1 - ld->serve_slot;
  ld->cv_free.notify_all();
  return n;
}

void fl_close(void* h) {
  if (!h) return;
  auto* ld = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->stop.store(true);
  }
  ld->cv_free.notify_all();
  ld->cv_ready.notify_all();
  if (ld->worker.joinable()) ld->worker.join();
  fclose(ld->f);
  delete ld;
}

// Standalone fast conversion helpers (used when frames arrive from Python).
void convert_u8_to_f32(const uint8_t* in, float* out, long n) {
  const float k = 1.0f / 255.0f;
  for (long i = 0; i < n; ++i) out[i] = in[i] * k;
}

// Packed RGB -> YIQ on host (NTSC matrix, RGBToYIQ.shader:46-50); useful for
// CPU-side preprocessing experiments and as a reference for the device path.
void rgb_to_yiq_f32(const float* in, float* out, long pixels) {
  for (long i = 0; i < pixels; ++i) {
    float r = in[3 * i], g = in[3 * i + 1], b = in[3 * i + 2];
    out[3 * i] = 0.299f * r + 0.587f * g + 0.114f * b;
    out[3 * i + 1] = 0.596f * r - 0.274f * g - 0.322f * b;
    out[3 * i + 2] = 0.211f * r - 0.523f * g + 0.312f * b;
  }
}

}  // extern "C"
