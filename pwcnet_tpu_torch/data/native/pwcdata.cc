// Native data-loading core for pwcnet_tpu_torch.
//
// The reference delegates decoding/augmentation to torch DataLoader worker
// processes (train.py:36-41). Here the hot host path — PPM (P6) and PNG
// (8-bit, non-interlaced; zlib inflate + the five standard filters) decode,
// Middlebury .flo parsing, crop/flip augmentation, uint8->float32
// normalization, and batch assembly — is a small C++ library driven from
// Python via ctypes (pwcnet_tpu_torch/data/native/__init__.py). A pthread worker
// pool decodes batch samples concurrently so file I/O overlaps with the
// training step even on low-core hosts. PNG support exists because Sintel,
// the main dataset, is PNG on disk. A copy of the JAX package's
// pwcnet_tpu/data/native/pwcdata.cc: the two packages share no file.
//
// Layouts (row-major, C-contiguous):
//   images_out: (batch, 2, crop_h, crop_w, 3) float32 in [0, 1]
//   flows_out:  (batch, crop_h, crop_w, 2)    float32 pixels
//
// Error codes: 0 ok; negative = -(errno-ish) documented per function.

#ifdef USE_LIBDEFLATE
#include <libdeflate.h>  // faster IDAT inflate than zlib
#else
#include <zlib.h>
#endif

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <type_traits>
#include <vector>

namespace {

constexpr float kFloMagic = 202021.25f;

struct Image {
  std::vector<uint8_t> data;  // h*w*3
  int h = 0, w = 0;
};

struct Flow {
  std::vector<float> data;  // h*w*2
  int h = 0, w = 0;
};

// -------- PPM (P6, binary, maxval 255) ------------------------------------
int ReadToken(FILE* f, char* buf, int cap) {
  int c;
  // skip whitespace and comments
  while ((c = fgetc(f)) != EOF) {
    if (c == '#') {
      while ((c = fgetc(f)) != EOF && c != '\n') {
      }
    } else if (!isspace(c)) {
      break;
    }
  }
  if (c == EOF) return -1;
  int n = 0;
  do {
    if (n + 1 >= cap) return -1;
    buf[n++] = static_cast<char>(c);
  } while ((c = fgetc(f)) != EOF && !isspace(c));
  buf[n] = '\0';
  return 0;
}

int ReadPpm(const char* path, Image* img) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char tok[32];
  if (ReadToken(f, tok, sizeof tok) || strcmp(tok, "P6") != 0) {
    fclose(f);
    return -2;  // not binary PPM
  }
  int w, h, maxval;
  if (ReadToken(f, tok, sizeof tok)) { fclose(f); return -3; }
  w = atoi(tok);
  if (ReadToken(f, tok, sizeof tok)) { fclose(f); return -3; }
  h = atoi(tok);
  if (ReadToken(f, tok, sizeof tok)) { fclose(f); return -3; }
  maxval = atoi(tok);
  if (w <= 0 || h <= 0 || maxval != 255) { fclose(f); return -4; }
  img->w = w;
  img->h = h;
  img->data.resize(static_cast<size_t>(h) * w * 3);
  size_t got = fread(img->data.data(), 1, img->data.size(), f);
  fclose(f);
  return got == img->data.size() ? 0 : -5;
}

// -------- PNG (8-bit depth, non-interlaced) ---------------------------------
// Minimal from-scratch reader for the subset flow datasets use (Sintel is
// 8-bit RGB, filter method 0, no interlace). Color types 0 (gray),
// 2 (RGB), 4 (gray+alpha), 6 (RGBA) are accepted and converted to RGB;
// palette (3), 16-bit depth, and Adam7 interlace return an error so the
// Python loader falls back to PIL. IDAT chunks are concatenated and
// inflated with zlib; rows are unfiltered per the five standard filters.
//
// Error codes: -1 open, -20 not PNG, -21 unsupported/bad IHDR,
// -22 bad chunk layout, -23 inflate failure, -24 bad filter byte.

constexpr uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t BE32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline int Paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

int ReadFileBytes(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n < 0) { fclose(f); return -1; }
  out->resize(static_cast<size_t>(n));
  size_t got = fread(out->data(), 1, out->size(), f);
  fclose(f);
  return got == out->size() ? 0 : -1;
}

int ReadPng(const char* path, Image* img) {
  std::vector<uint8_t> file;
  int rc = ReadFileBytes(path, &file);
  if (rc != 0) return rc;
  if (file.size() < 8 + 25 || memcmp(file.data(), kPngSig, 8) != 0)
    return -20;

  size_t pos = 8;
  int w = 0, h = 0, bit_depth = 0, color_type = 0, channels = 0;
  bool saw_ihdr = false, saw_iend = false;
  std::vector<uint8_t> idat;
  while (pos + 12 <= file.size()) {
    uint32_t len = BE32(&file[pos]);
    if (pos + 12 + size_t(len) > file.size()) return -22;
    const uint8_t* type = &file[pos + 4];
    const uint8_t* data = &file[pos + 8];
    if (memcmp(type, "IHDR", 4) == 0) {
      if (len != 13) return -21;
      w = static_cast<int>(BE32(data));
      h = static_cast<int>(BE32(data + 4));
      bit_depth = data[8];
      color_type = data[9];
      // compression(10) must be 0, filter(11) must be 0, interlace(12)
      // must be 0 (Adam7 unsupported — PIL fallback)
      if (w <= 0 || h <= 0 || bit_depth != 8 || data[10] != 0 ||
          data[11] != 0 || data[12] != 0)
        return -21;
      switch (color_type) {
        case 0: channels = 1; break;
        case 2: channels = 3; break;
        case 4: channels = 2; break;
        case 6: channels = 4; break;
        default: return -21;  // palette (3) unsupported
      }
      saw_ihdr = true;
    } else if (memcmp(type, "IDAT", 4) == 0) {
      if (!saw_ihdr) return -22;
      idat.insert(idat.end(), data, data + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      saw_iend = true;
      break;
    }
    // ancillary chunks (tEXt, gAMA, ...) are skipped; CRCs are not
    // verified (decode errors surface as inflate/filter failures)
    pos += 12 + len;
  }
  if (!saw_ihdr || !saw_iend || idat.empty()) return -22;

  const size_t stride = static_cast<size_t>(w) * channels;
  std::vector<uint8_t> raw(static_cast<size_t>(h) * (stride + 1));
  {
#ifdef USE_LIBDEFLATE
    // per-worker-thread decompressor, reused across frames
    static thread_local libdeflate_decompressor* d =
        libdeflate_alloc_decompressor();
    if (!d) return -23;
    size_t actual = 0;
    if (libdeflate_zlib_decompress(d, idat.data(), idat.size(), raw.data(),
                                   raw.size(), &actual) !=
            LIBDEFLATE_SUCCESS ||
        actual != raw.size())
      return -23;
#else
    z_stream zs;
    memset(&zs, 0, sizeof zs);
    if (inflateInit(&zs) != Z_OK) return -23;
    zs.next_in = idat.data();
    zs.avail_in = static_cast<uInt>(idat.size());
    zs.next_out = raw.data();
    zs.avail_out = static_cast<uInt>(raw.size());
    int zrc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (zrc != Z_STREAM_END || zs.total_out != raw.size()) return -23;
#endif
  }

  // unfilter in place (each row: filter byte + stride pixel bytes)
  const int bpp = channels;  // bytes per pixel at depth 8
  for (int y = 0; y < h; ++y) {
    uint8_t* row = &raw[static_cast<size_t>(y) * (stride + 1)];
    const uint8_t filter = row[0];
    uint8_t* cur = row + 1;
    const uint8_t* up =
        y > 0 ? &raw[static_cast<size_t>(y - 1) * (stride + 1)] + 1 : nullptr;
    switch (filter) {
      case 0:
        break;
      case 1:  // Sub
        for (size_t x = bpp; x < stride; ++x) cur[x] += cur[x - bpp];
        break;
      case 2:  // Up
        if (up)
          for (size_t x = 0; x < stride; ++x) cur[x] += up[x];
        break;
      case 3:  // Average
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(bpp) ? cur[x - bpp] : 0;
          int b = up ? up[x] : 0;
          cur[x] = static_cast<uint8_t>(cur[x] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(bpp) ? cur[x - bpp] : 0;
          int b = up ? up[x] : 0;
          int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
          cur[x] = static_cast<uint8_t>(cur[x] + Paeth(a, b, c));
        }
        break;
      default:
        return -24;
    }
  }

  // convert to packed RGB
  img->w = w;
  img->h = h;
  img->data.resize(static_cast<size_t>(h) * w * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = &raw[static_cast<size_t>(y) * (stride + 1)] + 1;
    uint8_t* dst = &img->data[static_cast<size_t>(y) * w * 3];
    switch (color_type) {
      case 2:
        memcpy(dst, src, static_cast<size_t>(w) * 3);
        break;
      case 6:
        for (int x = 0; x < w; ++x) {
          dst[x * 3 + 0] = src[x * 4 + 0];
          dst[x * 3 + 1] = src[x * 4 + 1];
          dst[x * 3 + 2] = src[x * 4 + 2];
        }
        break;
      case 0:
        for (int x = 0; x < w; ++x)
          dst[x * 3 + 0] = dst[x * 3 + 1] = dst[x * 3 + 2] = src[x];
        break;
      case 4:
        for (int x = 0; x < w; ++x)
          dst[x * 3 + 0] = dst[x * 3 + 1] = dst[x * 3 + 2] = src[x * 2];
        break;
    }
  }
  return 0;
}

// -------- format dispatch ----------------------------------------------------
int ReadImage(const char* path, Image* img) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, sizeof magic, f);
  fclose(f);
  if (got >= 8 && memcmp(magic, kPngSig, 8) == 0) return ReadPng(path, img);
  if (got >= 2 && magic[0] == 'P' && magic[1] == '6')
    return ReadPpm(path, img);
  return -2;  // unknown format
}

// -------- .flo --------------------------------------------------------------
int ReadFlo(const char* path, Flow* flow) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  float magic;
  int32_t w, h;
  if (fread(&magic, 4, 1, f) != 1 || magic != kFloMagic) {
    fclose(f);
    return -2;
  }
  if (fread(&w, 4, 1, f) != 1 || fread(&h, 4, 1, f) != 1 || w <= 0 ||
      h <= 0) {
    fclose(f);
    return -3;
  }
  flow->w = w;
  flow->h = h;
  flow->data.resize(static_cast<size_t>(h) * w * 2);
  size_t got = fread(flow->data.data(), 4, flow->data.size(), f);
  fclose(f);
  return got == flow->data.size() ? 0 : -5;
}

// -------- crop + flip + normalize (shared by decode and cache paths) -------
// Crop a (crop_h, crop_w) window at (y0, x0) out of a raw u8 RGB frame of
// width src_w, apply h/v flips, and normalize to [0, 1] float32.
void CropNormalizeFrame(const uint8_t* src, int src_w, int crop_h, int crop_w,
                        int y0, int x0, bool hflip, bool vflip, float* dst) {
  const float inv = 1.0f / 255.0f;
  for (int y = 0; y < crop_h; ++y) {
    int sy = y0 + (vflip ? crop_h - 1 - y : y);
    const uint8_t* row = src + (static_cast<size_t>(sy) * src_w + x0) * 3;
    float* orow = dst + static_cast<size_t>(y) * crop_w * 3;
    if (!hflip) {
      for (int x = 0; x < crop_w * 3; ++x) orow[x] = row[x] * inv;
    } else {
      for (int x = 0; x < crop_w; ++x) {
        const uint8_t* px = row + (crop_w - 1 - x) * 3;
        orow[x * 3 + 0] = px[0] * inv;
        orow[x * 3 + 1] = px[1] * inv;
        orow[x * 3 + 2] = px[2] * inv;
      }
    }
  }
}

// Same crop/flip but KEEPING uint8 (the device-normalize pipeline: the
// /255 happens on the device, so the host moves 4x fewer image bytes and the
// PCIe transfer shrinks the same way). No-flip rows are pure memcpy.
void CropFrameU8(const uint8_t* src, int src_w, int crop_h, int crop_w,
                 int y0, int x0, bool hflip, bool vflip, uint8_t* dst) {
  for (int y = 0; y < crop_h; ++y) {
    int sy = y0 + (vflip ? crop_h - 1 - y : y);
    const uint8_t* row = src + (static_cast<size_t>(sy) * src_w + x0) * 3;
    uint8_t* orow = dst + static_cast<size_t>(y) * crop_w * 3;
    if (!hflip) {
      memcpy(orow, row, static_cast<size_t>(crop_w) * 3);
    } else {
      for (int x = 0; x < crop_w; ++x) {
        const uint8_t* px = row + (crop_w - 1 - x) * 3;
        orow[x * 3 + 0] = px[0];
        orow[x * 3 + 1] = px[1];
        orow[x * 3 + 2] = px[2];
      }
    }
  }
}

// Same crop/flip for the (H, W, 2) float32 flow, negating the flipped
// components (matching datasets.FlowDataset.__getitem__). The unflipped
// row copy is pure memcpy.
void CropFlipFlow(const float* src, int src_w, int crop_h, int crop_w, int y0,
                  int x0, bool hflip, bool vflip, float* dst) {
  if (!hflip && !vflip) {
    for (int y = 0; y < crop_h; ++y)
      memcpy(dst + static_cast<size_t>(y) * crop_w * 2,
             src + (static_cast<size_t>(y0 + y) * src_w + x0) * 2,
             static_cast<size_t>(crop_w) * 2 * sizeof(float));
    return;
  }
  const float sx = hflip ? -1.0f : 1.0f;
  const float sy_ = vflip ? -1.0f : 1.0f;
  for (int y = 0; y < crop_h; ++y) {
    int srcy = y0 + (vflip ? crop_h - 1 - y : y);
    const float* row = src + (static_cast<size_t>(srcy) * src_w + x0) * 2;
    float* orow = dst + static_cast<size_t>(y) * crop_w * 2;
    for (int x = 0; x < crop_w; ++x) {
      int srcx = (hflip ? crop_w - 1 - x : x) * 2;
      orow[x * 2 + 0] = row[srcx + 0] * sx;
      orow[x * 2 + 1] = row[srcx + 1] * sy_;
    }
  }
}

// -------- one sample: decode + crop + flip + normalize ---------------------
int LoadSample(const char* img0_path, const char* img1_path,
               const char* flo_path, int crop_h, int crop_w, int y0, int x0,
               unsigned flip_bits, float* images_out, float* flows_out) {
  Image im0, im1;
  Flow fl;
  int rc;
  if ((rc = ReadImage(img0_path, &im0)) != 0) return rc;
  if ((rc = ReadImage(img1_path, &im1)) != 0) return rc * 10;
  if ((rc = ReadFlo(flo_path, &fl)) != 0) return rc * 100;
  if (im0.h != im1.h || im0.w != im1.w || fl.h != im0.h || fl.w != im0.w)
    return -1000;
  if (y0 < 0 || x0 < 0 || y0 + crop_h > im0.h || x0 + crop_w > im0.w)
    return -1001;

  const bool hflip = flip_bits & 1u;
  const bool vflip = flip_bits & 2u;
  const size_t frame_stride = static_cast<size_t>(crop_h) * crop_w * 3;
  CropNormalizeFrame(im0.data.data(), im0.w, crop_h, crop_w, y0, x0, hflip,
                     vflip, images_out);
  CropNormalizeFrame(im1.data.data(), im1.w, crop_h, crop_w, y0, x0, hflip,
                     vflip, images_out + frame_stride);
  CropFlipFlow(fl.data.data(), fl.w, crop_h, crop_w, y0, x0, hflip, vflip,
               flows_out);
  return 0;
}

// Assemble a batch straight from a pre-decoded raw cache (pwcnet_tpu_torch.data.
// cache): `frames` is the base of an (n_frames, frame_h, frame_w, 3) uint8
// memmap, `flows` of an (n_flows, frame_h, frame_w, 2) float32 memmap.
// Per sample i the pair (img0_idx[i], img1_idx[i]) indexes frames and
// flow_idx[i] indexes flows; crop/flip semantics are identical to the
// decode path (LoadSample) — pure memory traffic, no decompression.
// ImgT float: host-normalized [0,1] images; ImgT uint8: raw bytes for the
// device-normalize pipeline (4x fewer host+PCIe image bytes).
// Returns 0, or -1001 for an out-of-bounds crop, -1002 for a bad index.
template <typename ImgT>
int AssembleCachedImpl(const uint8_t* frames, const float* flows,
                       int n_frames, int n_flows, int frame_h, int frame_w,
                       int batch, int crop_h, int crop_w,
                       const int* img0_idx, const int* img1_idx,
                       const int* flow_idx, const int* y0s, const int* x0s,
                       const unsigned char* flip_bits, ImgT* images_out,
                       float* flows_out, int num_threads) {
  if (batch <= 0 || crop_h <= 0 || crop_w <= 0) return -7;
  const size_t fpx = static_cast<size_t>(frame_h) * frame_w;
  const size_t img_stride = static_cast<size_t>(2) * crop_h * crop_w * 3;
  const size_t flo_stride = static_cast<size_t>(crop_h) * crop_w * 2;

  std::vector<int> rcs(batch, 0);
  int nt = num_threads < 1 ? 1 : (num_threads > batch ? batch : num_threads);
  std::vector<std::thread> workers;
  for (int t = 0; t < nt; ++t) {
    workers.emplace_back([&, t]() {
      for (int i = t; i < batch; i += nt) {
        const int i0 = img0_idx[i], i1 = img1_idx[i], fi = flow_idx[i];
        if (i0 < 0 || i0 >= n_frames || i1 < 0 || i1 >= n_frames ||
            fi < 0 || fi >= n_flows) {
          rcs[i] = -1002;
          continue;
        }
        const int y0 = y0s[i], x0 = x0s[i];
        if (y0 < 0 || x0 < 0 || y0 + crop_h > frame_h ||
            x0 + crop_w > frame_w) {
          rcs[i] = -1001;
          continue;
        }
        const bool hflip = flip_bits[i] & 1u;
        const bool vflip = flip_bits[i] & 2u;
        ImgT* img_dst = images_out + i * img_stride;
        for (int fr = 0; fr < 2; ++fr) {
          const uint8_t* src =
              frames + static_cast<size_t>(fr == 0 ? i0 : i1) * fpx * 3;
          ImgT* dst = img_dst + fr * (img_stride / 2);
          if constexpr (std::is_same_v<ImgT, float>) {
            CropNormalizeFrame(src, frame_w, crop_h, crop_w, y0, x0, hflip,
                               vflip, dst);
          } else {
            CropFrameU8(src, frame_w, crop_h, crop_w, y0, x0, hflip, vflip,
                        dst);
          }
        }
        CropFlipFlow(flows + static_cast<size_t>(fi) * fpx * 2, frame_w,
                     crop_h, crop_w, y0, x0, hflip, vflip,
                     flows_out + i * flo_stride);
      }
    });
  }
  for (auto& th : workers) th.join();
  for (int rc : rcs)
    if (rc != 0) return rc;
  return 0;
}


}  // namespace

extern "C" {

int pwc_image_size(const char* path, int* h, int* w) {
  Image im;
  // Full decode, not a header-only parse: doubles as the loader's
  // decodability probe (a PNG variant this reader does not support —
  // 16-bit, palette, interlaced — must fail HERE so the Python side
  // falls back to PIL before committing the epoch to the native path).
  int rc = ReadImage(path, &im);
  if (rc != 0) return rc;
  *h = im.h;
  *w = im.w;
  return 0;
}

int pwc_read_flo(const char* path, float* out, int max_floats, int* h,
                 int* w) {
  Flow fl;
  int rc = ReadFlo(path, &fl);
  if (rc != 0) return rc;
  if (static_cast<int>(fl.data.size()) > max_floats) return -6;
  memcpy(out, fl.data.data(), fl.data.size() * 4);
  *h = fl.h;
  *w = fl.w;
  return 0;
}

int pwc_assemble_cached(const uint8_t* frames, const float* flows,
                        int n_frames, int n_flows, int frame_h, int frame_w,
                        int batch, int crop_h, int crop_w,
                        const int* img0_idx, const int* img1_idx,
                        const int* flow_idx, const int* y0s, const int* x0s,
                        const unsigned char* flip_bits, float* images_out,
                        float* flows_out, int num_threads) {
  return AssembleCachedImpl<float>(
      frames, flows, n_frames, n_flows, frame_h, frame_w, batch, crop_h,
      crop_w, img0_idx, img1_idx, flow_idx, y0s, x0s, flip_bits, images_out,
      flows_out, num_threads);
}

int pwc_assemble_cached_u8(const uint8_t* frames, const float* flows,
                           int n_frames, int n_flows, int frame_h,
                           int frame_w, int batch, int crop_h, int crop_w,
                           const int* img0_idx, const int* img1_idx,
                           const int* flow_idx, const int* y0s,
                           const int* x0s, const unsigned char* flip_bits,
                           uint8_t* images_out, float* flows_out,
                           int num_threads) {
  return AssembleCachedImpl<uint8_t>(
      frames, flows, n_frames, n_flows, frame_h, frame_w, batch, crop_h,
      crop_w, img0_idx, img1_idx, flow_idx, y0s, x0s, flip_bits, images_out,
      flows_out, num_threads);
}

// Load a full batch concurrently. Returns 0, or the first non-zero sample
// error code encountered.
int pwc_load_batch(const char** img0_paths, const char** img1_paths,
                   const char** flo_paths, int batch, int crop_h, int crop_w,
                   const int* y0s, const int* x0s,
                   const unsigned char* flip_bits, float* images_out,
                   float* flows_out, int num_threads) {
  if (batch <= 0 || crop_h <= 0 || crop_w <= 0) return -7;
  const size_t img_stride = static_cast<size_t>(2) * crop_h * crop_w * 3;
  const size_t flo_stride = static_cast<size_t>(crop_h) * crop_w * 2;

  std::vector<int> rcs(batch, 0);
  int nt = num_threads < 1 ? 1 : (num_threads > batch ? batch : num_threads);
  std::vector<std::thread> workers;
  for (int t = 0; t < nt; ++t) {
    workers.emplace_back([&, t]() {
      for (int i = t; i < batch; i += nt) {
        rcs[i] = LoadSample(img0_paths[i], img1_paths[i], flo_paths[i],
                            crop_h, crop_w, y0s[i], x0s[i], flip_bits[i],
                            images_out + i * img_stride,
                            flows_out + i * flo_stride);
      }
    });
  }
  for (auto& th : workers) th.join();
  for (int rc : rcs)
    if (rc != 0) return rc;
  return 0;
}

}  // extern "C"
