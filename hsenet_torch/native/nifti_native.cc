// Native NIfTI-1 decoder and threaded batch loader of the port.
//
// One C++ pass per volume: zlib inflate (gzopen reads plain files too),
// header parse, and a fused dtype-convert + scl_slope/inter pass straight
// into the caller's float32 buffer; plus a std::thread pool for batch
// decode, so that the card's preprocessing (hsenet_torch/data/preprocess.py)
// does not wait on a Python decode.
//
// Layout note: NIfTI stores x fastest (Fortran (nx,ny,nz)); the pipeline
// consumes z-leading C-order (nz,ny,nx). Those are the SAME linear layout
// (index = x + y*nx + z*nx*ny), so the decode pass is a straight sweep.
//
// Exposed C ABI (ctypes, see hsenet_torch/native/__init__.py):
//   nifti_probe(path, shape[3], spacing[3], &slope, &inter) -> 0 | err
//   nifti_decode_f32(path, out, n, apply_scl) -> 0 | err
//   nifti_decode_batch_f32(paths, n_files, out, vol_elems, apply_scl,
//                          n_threads) -> 0 | first err
//   nifti_errstr(code) -> static message

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kErrOpen = 1;
constexpr int kErrHeader = 2;
constexpr int kErrMagic = 3;
constexpr int kErrDtype = 4;
constexpr int kErrTruncated = 5;
constexpr int kErrSize = 6;

const char* kMessages[] = {
    "ok",
    "cannot open file",
    "truncated or invalid NIfTI-1 header",
    "bad NIfTI magic",
    "unsupported NIfTI datatype",
    "truncated data section",
    "output buffer size does not match volume",
};

struct Header {
  int64_t shape[3];
  float spacing[3];
  float slope;
  float inter;
  int datatype;
  int64_t vox_offset;
  bool swap;  // byte-swapped (big-endian file on little-endian host)
};

uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }

int16_t rd_i16(const unsigned char* p, bool swap) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  if (swap) v = bswap16(v);
  int16_t out;
  std::memcpy(&out, &v, 2);
  return out;
}

float rd_f32(const unsigned char* p, bool swap) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  if (swap) v = bswap32(v);
  float out;
  std::memcpy(&out, &v, 4);
  return out;
}

int parse_header(const unsigned char* h, Header* out) {
  int32_t sizeof_hdr;
  std::memcpy(&sizeof_hdr, h, 4);
  bool swap = false;
  if (sizeof_hdr != 348) {
    sizeof_hdr = (int32_t)bswap32((uint32_t)sizeof_hdr);
    if (sizeof_hdr != 348) return kErrHeader;
    swap = true;
  }
  if (!(h[344] == 'n' && (h[345] == '+' || h[345] == 'i'))) return kErrMagic;

  int16_t ndim = rd_i16(h + 40, swap);
  if (ndim < 1 || ndim > 7) return kErrHeader;
  for (int i = 0; i < 3; ++i) {
    int16_t d = (i < ndim) ? rd_i16(h + 40 + 2 * (i + 1), swap) : 1;
    out->shape[i] = d > 0 ? d : 1;  // (nx, ny, nz)
  }
  out->datatype = rd_i16(h + 70, swap);
  for (int i = 0; i < 3; ++i) out->spacing[i] = rd_f32(h + 76 + 4 * (i + 1), swap);
  out->vox_offset = (int64_t)rd_f32(h + 108, swap);
  out->slope = rd_f32(h + 112, swap);
  out->inter = rd_f32(h + 116, swap);
  if (!(out->slope == out->slope) || out->slope == 0.0f) out->slope = 1.0f;
  if (!(out->inter == out->inter)) out->inter = 0.0f;
  if (out->vox_offset < 348) out->vox_offset = 352;
  out->swap = swap;
  return kOk;
}

int dtype_size(int code) {
  switch (code) {
    case 2:   return 1;  // uint8
    case 4:   return 2;  // int16
    case 8:   return 4;  // int32
    case 16:  return 4;  // float32
    case 64:  return 8;  // float64
    case 256: return 1;  // int8
    case 512: return 2;  // uint16
    case 768: return 4;  // uint32
    default:  return 0;
  }
}

template <typename T>
void convert(const unsigned char* src, float* dst, int64_t n, bool swap,
             float slope, float inter) {
  const T* in = reinterpret_cast<const T*>(src);
  for (int64_t i = 0; i < n; ++i) {
    T v = in[i];
    if (swap && sizeof(T) == 2) {
      uint16_t u;
      std::memcpy(&u, &v, 2);
      u = bswap16(u);
      std::memcpy(&v, &u, 2);
    } else if (swap && sizeof(T) == 4) {
      uint32_t u;
      std::memcpy(&u, &v, 4);
      u = bswap32(u);
      std::memcpy(&v, &u, 4);
    } else if (swap && sizeof(T) == 8) {
      uint64_t u;
      std::memcpy(&u, &v, 8);
      u = __builtin_bswap64(u);
      std::memcpy(&v, &u, 8);
    }
    dst[i] = slope * (float)v + inter;
  }
}

int decode_one(const char* path, float* out, int64_t n, int apply_scl,
               Header* hdr_out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return kErrOpen;
  // larger inflate buffer: fewer syscalls on big CT volumes
  gzbuffer(f, 1 << 20);

  unsigned char header[352];
  if (gzread(f, header, 348) != 348) {
    gzclose(f);
    return kErrHeader;
  }
  Header hdr;
  int rc = parse_header(header, &hdr);
  if (rc != kOk) {
    gzclose(f);
    return rc;
  }
  int isize = dtype_size(hdr.datatype);
  if (isize == 0) {
    gzclose(f);
    return kErrDtype;
  }
  int64_t count = hdr.shape[0] * hdr.shape[1] * hdr.shape[2];
  if (out != nullptr) {
    if (count != n) {
      gzclose(f);
      return kErrSize;
    }
    // skip to vox_offset
    int64_t skip = hdr.vox_offset - 348;
    std::vector<unsigned char> scratch(4096);
    while (skip > 0) {
      int chunk = (int)(skip < (int64_t)scratch.size() ? skip
                                                       : scratch.size());
      if (gzread(f, scratch.data(), chunk) != chunk) {
        gzclose(f);
        return kErrTruncated;
      }
      skip -= chunk;
    }
    std::vector<unsigned char> raw((size_t)count * isize);
    int64_t want = count * isize, got = 0;
    while (got < want) {
      int chunk = (int)((want - got) > (1 << 30) ? (1 << 30) : (want - got));
      int r = gzread(f, raw.data() + got, chunk);
      if (r <= 0) {
        gzclose(f);
        return kErrTruncated;
      }
      got += r;
    }
    float slope = apply_scl ? hdr.slope : 1.0f;
    float inter = apply_scl ? hdr.inter : 0.0f;
    switch (hdr.datatype) {
      case 2:   convert<uint8_t>(raw.data(), out, count, false, slope, inter); break;
      case 4:   convert<int16_t>(raw.data(), out, count, hdr.swap, slope, inter); break;
      case 8:   convert<int32_t>(raw.data(), out, count, hdr.swap, slope, inter); break;
      case 16:  convert<float>(raw.data(), out, count, hdr.swap, slope, inter); break;
      case 64:  convert<double>(raw.data(), out, count, hdr.swap, slope, inter); break;
      case 256: convert<int8_t>(raw.data(), out, count, false, slope, inter); break;
      case 512: convert<uint16_t>(raw.data(), out, count, hdr.swap, slope, inter); break;
      case 768: convert<uint32_t>(raw.data(), out, count, hdr.swap, slope, inter); break;
    }
  }
  gzclose(f);
  if (hdr_out) *hdr_out = hdr;
  return kOk;
}

}  // namespace

extern "C" {

const char* nifti_errstr(int code) {
  if (code < 0 || code > kErrSize) return "unknown error";
  return kMessages[code];
}

int nifti_probe(const char* path, int64_t shape_out[3], float spacing_out[3],
                float* slope, float* inter) {
  Header hdr;
  int rc = decode_one(path, nullptr, 0, 0, &hdr);
  if (rc != kOk) return rc;
  // shape reported z-leading (nz, ny, nx) to match the pipeline layout
  shape_out[0] = hdr.shape[2];
  shape_out[1] = hdr.shape[1];
  shape_out[2] = hdr.shape[0];
  spacing_out[0] = hdr.spacing[2];
  spacing_out[1] = hdr.spacing[1];
  spacing_out[2] = hdr.spacing[0];
  *slope = hdr.slope;
  *inter = hdr.inter;
  return kOk;
}

int nifti_decode_f32(const char* path, float* out, int64_t n, int apply_scl) {
  return decode_one(path, out, n, apply_scl, nullptr);
}

int nifti_decode_batch_f32(const char** paths, int n_files, float* out,
                           int64_t vol_elems, int apply_scl, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> err(kOk);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_files || err.load() != kOk) return;
      int rc = decode_one(paths[i], out + (int64_t)i * vol_elems, vol_elems,
                          apply_scl, nullptr);
      if (rc != kOk) {
        int expected = kOk;
        err.compare_exchange_strong(expected, rc);
      }
    }
  };
  std::vector<std::thread> pool;
  int nt = n_threads < n_files ? n_threads : n_files;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return err.load();
}

}  // extern "C"
