// JPEG decode + bilinear resize for the port's image datasets, from
// sgg/native/jpeg_loader.cc: decode at the smallest scale whose output stays
// >= the target (DCT prescale), a fixed-point 16.16 bilinear resize, and a
// std::thread fan-out across the images of a batch. A plain C interface for
// ctypes (sgg_torch/native/loader.py builds and binds it).
//
// One of two decoders is compiled in:
//   SGG_DECODER_LIBJPEG  libjpeg, with its DCT prescale (scale_denom), as the
//                        reference decodes;
//   SGG_DECODER_NVJPEG   nvJPEG (the CUDA toolkit's decoder) into device
//                        memory, copied back to the host; the prescale is an
//                        integer box average over the largest power of two
//                        <= libjpeg's denominator. Its bytes may differ from
//                        libjpeg's (another IDCT and chroma upsampling).
// The resize and the thread pool are the reference's, for either decoder.
//
// The same library encodes JPEGs (the synthetic corpus writer; the reference
// writes them with PIL): with libjpeg's compressor at PIL's settings
// (baseline, 4:2:0, the standard tables at the quality given), or with
// nvJPEG's encoder at the same quality and 4:2:0, whichever decoder is built.

#include <cstddef>
#include <cstdio>  // before jpeglib.h, which uses FILE and size_t unqualified

#include <atomic>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#if defined(SGG_DECODER_LIBJPEG)
#include <csetjmp>

#include <jpeglib.h>
#elif defined(SGG_DECODER_NVJPEG)
#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <mutex>
#else
#error "define SGG_DECODER_LIBJPEG or SGG_DECODER_NVJPEG"
#endif

namespace {

// Return codes: 0 ok, 1 the file cannot be opened, 2 the decoder rejects it
// (corrupt, or a layout it cannot give as RGB), 3 the caller's buffer is too
// small, 4 the decoder cannot start.
constexpr int kOk = 0, kNoFile = 1, kRejected = 2, kTooSmall = 3, kNoDecoder = 4;

// Bilinear resize RGB8 HxW -> out x out (fixed-point 16.16), the reference's.
void resize_bilinear(const unsigned char* src, int h, int w, unsigned char* dst, int out) {
  const long sx = (static_cast<long>(w) << 16) / out;
  const long sy = (static_cast<long>(h) << 16) / out;
  for (int y = 0; y < out; ++y) {
    long fy = y * sy + (sy >> 1) - (1 << 15);
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy >> 16);
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    int wy = static_cast<int>((fy >> 8) & 0xFF);
    const unsigned char* r0 = src + static_cast<size_t>(y0) * w * 3;
    const unsigned char* r1 = src + static_cast<size_t>(y1) * w * 3;
    unsigned char* d = dst + static_cast<size_t>(y) * out * 3;
    for (int x = 0; x < out; ++x) {
      long fx = x * sx + (sx >> 1) - (1 << 15);
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx >> 16);
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      int wx = static_cast<int>((fx >> 8) & 0xFF);
      for (int c = 0; c < 3; ++c) {
        int p00 = r0[x0 * 3 + c], p01 = r0[x1 * 3 + c];
        int p10 = r1[x0 * 3 + c], p11 = r1[x1 * 3 + c];
        int top = p00 * (256 - wx) + p01 * wx;
        int bot = p10 * (256 - wx) + p11 * wx;
        d[x * 3 + c] = static_cast<unsigned char>((top * (256 - wy) + bot * wy) >> 16);
      }
    }
  }
}

// The DCT prescale's denominator: the largest of 8..1 whose output stays
// >= out_size on both sides.
int prescale_denom(int width, int height, int out_size) {
  for (int denom = 8; denom >= 1; --denom) {
    if (width / denom >= out_size && height / denom >= out_size) return denom;
  }
  return 1;
}

#if defined(SGG_DECODER_LIBJPEG)

const char* kRoute = "libjpeg";

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode at the prescaled size into rgb [h, w, 3].
int decode_raw(const char* path, int out_size, std::vector<unsigned char>& rgb, int& h,
               int& w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kNoFile;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return kRejected;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = prescale_denom(static_cast<int>(cinfo.image_width),
                                     static_cast<int>(cinfo.image_height), out_size);
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  rgb.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return kOk;
}

int decoder_ready() { return kOk; }

// rgb [h, w, 3] -> a baseline JPEG at path: jpeg_set_defaults (YCbCr, 4:2:0,
// Huffman tables not optimized), jpeg_set_quality(quality, force_baseline),
// as PIL's JPEG encoder with its default options.
int encode_file(const char* path, int h, int w, const unsigned char* rgb, int quality) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return kNoFile;
  jpeg_compress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    std::fclose(f);
    return kRejected;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(rgb + static_cast<size_t>(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return std::fclose(f) == 0 ? kOk : kNoFile;
}

#else  // SGG_DECODER_NVJPEG

const char* kRoute = "nvjpeg";

// One nvJPEG handle for the process; a decode state, a stream and a device
// buffer per worker, kept in a pool so that a batch's threads reuse them.
struct Worker {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dbuf = nullptr;
  size_t cap = 0;
  nvjpegEncoderState_t enc_state = nullptr;  // made at the worker's first encode
  nvjpegEncoderParams_t enc_params = nullptr;
  int enc_quality = -1;
};

std::once_flag g_once;
nvjpegHandle_t g_handle = nullptr;
int g_init_rc = kNoDecoder;
std::mutex g_pool_mu;
std::vector<Worker*> g_pool;

int decoder_ready() {
  std::call_once(g_once, [] {
    if (nvjpegCreateSimple(&g_handle) == NVJPEG_STATUS_SUCCESS) g_init_rc = kOk;
  });
  return g_init_rc;
}

Worker* acquire() {
  {
    std::lock_guard<std::mutex> lock(g_pool_mu);
    if (!g_pool.empty()) {
      Worker* wk = g_pool.back();
      g_pool.pop_back();
      return wk;
    }
  }
  Worker* wk = new Worker();
  if (nvjpegJpegStateCreate(g_handle, &wk->state) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamCreateWithFlags(&wk->stream, cudaStreamNonBlocking) != cudaSuccess) {
    delete wk;
    return nullptr;
  }
  return wk;
}

void release(Worker* wk) {
  std::lock_guard<std::mutex> lock(g_pool_mu);
  g_pool.push_back(wk);
}

// Box average over f x f blocks (partial blocks at the edges over what they
// hold), rounded to nearest: [h, w, 3] -> [ceil(h/f), ceil(w/f), 3].
void box_downsample(const std::vector<unsigned char>& src, int h, int w, int f,
                    std::vector<unsigned char>& dst, int& oh, int& ow) {
  oh = (h + f - 1) / f;
  ow = (w + f - 1) / f;
  dst.resize(static_cast<size_t>(oh) * ow * 3);
  for (int y = 0; y < oh; ++y) {
    const int y_end = (y + 1) * f < h ? (y + 1) * f : h;
    for (int x = 0; x < ow; ++x) {
      const int x_end = (x + 1) * f < w ? (x + 1) * f : w;
      const int cnt = (y_end - y * f) * (x_end - x * f);
      for (int c = 0; c < 3; ++c) {
        int sum = 0;
        for (int yy = y * f; yy < y_end; ++yy)
          for (int xx = x * f; xx < x_end; ++xx)
            sum += src[(static_cast<size_t>(yy) * w + xx) * 3 + c];
        dst[(static_cast<size_t>(y) * ow + x) * 3 + c] =
            static_cast<unsigned char>((sum + cnt / 2) / cnt);
      }
    }
  }
}

// The worker's device buffer grown to at least need bytes.
bool reserve(Worker* wk, size_t need) {
  if (wk->cap >= need) return true;
  if (wk->dbuf) cudaFree(wk->dbuf);
  wk->dbuf = nullptr;
  wk->cap = 0;
  if (cudaMalloc(&wk->dbuf, need) != cudaSuccess) return false;
  wk->cap = need;
  return true;
}

int decode_raw(const char* path, int out_size, std::vector<unsigned char>& rgb, int& h,
               int& w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kNoFile;
  std::vector<unsigned char> data;
  unsigned char chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof(chunk), f)) > 0)
    data.insert(data.end(), chunk, chunk + got);
  std::fclose(f);
  if (decoder_ready() != kOk) return kNoDecoder;
  int n_comp = 0;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (data.empty() ||
      nvjpegGetImageInfo(g_handle, data.data(), data.size(), &n_comp, &sub, widths,
                         heights) != NVJPEG_STATUS_SUCCESS ||
      (n_comp != 1 && n_comp != 3) || widths[0] <= 0 || heights[0] <= 0)
    return kRejected;
  const int fw = widths[0], fh = heights[0];
  const size_t need = static_cast<size_t>(fw) * fh * 3;
  Worker* wk = acquire();
  if (!wk) return kNoDecoder;
  if (!reserve(wk, need)) {
    release(wk);
    return kNoDecoder;
  }
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = wk->dbuf;
  img.pitch[0] = static_cast<unsigned int>(fw) * 3;
  std::vector<unsigned char> full(need);
  const bool ok =
      nvjpegDecode(g_handle, wk->state, data.data(), data.size(), NVJPEG_OUTPUT_RGBI, &img,
                   wk->stream) == NVJPEG_STATUS_SUCCESS &&
      cudaMemcpyAsync(full.data(), wk->dbuf, need, cudaMemcpyDeviceToHost, wk->stream) ==
          cudaSuccess &&
      cudaStreamSynchronize(wk->stream) == cudaSuccess;
  release(wk);
  if (!ok) return kRejected;
  int denom = prescale_denom(fw, fh, out_size), f2 = 1;
  while (f2 * 2 <= denom) f2 *= 2;
  if (f2 == 1) {
    rgb.swap(full);
    h = fh;
    w = fw;
  } else {
    box_downsample(full, fh, fw, f2, rgb, h, w);
  }
  return kOk;
}

// rgb [h, w, 3] -> a baseline JPEG at path through nvJPEG's encoder: the
// image copied to the worker's device buffer, 4:2:0, the quality given,
// Huffman tables not optimized; the bitstream copied back and written.
int encode_file(const char* path, int h, int w, const unsigned char* rgb, int quality) {
  if (decoder_ready() != kOk) return kNoDecoder;
  const size_t n = static_cast<size_t>(w) * h * 3;
  Worker* wk = acquire();
  if (!wk) return kNoDecoder;
  bool ok = reserve(wk, n);
  if (ok && !wk->enc_state) {
    ok = nvjpegEncoderStateCreate(g_handle, &wk->enc_state, wk->stream) ==
             NVJPEG_STATUS_SUCCESS &&
         nvjpegEncoderParamsCreate(g_handle, &wk->enc_params, wk->stream) ==
             NVJPEG_STATUS_SUCCESS &&
         nvjpegEncoderParamsSetSamplingFactors(wk->enc_params, NVJPEG_CSS_420, wk->stream) ==
             NVJPEG_STATUS_SUCCESS &&
         nvjpegEncoderParamsSetOptimizedHuffman(wk->enc_params, 0, wk->stream) ==
             NVJPEG_STATUS_SUCCESS;
    if (!ok) wk->enc_state = nullptr;
  }
  if (ok && wk->enc_quality != quality) {
    ok = nvjpegEncoderParamsSetQuality(wk->enc_params, quality, wk->stream) ==
         NVJPEG_STATUS_SUCCESS;
    if (ok) wk->enc_quality = quality;
  }
  std::vector<unsigned char> jpeg;
  size_t length = 0;
  if (ok) {
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    img.channel[0] = wk->dbuf;
    img.pitch[0] = static_cast<unsigned int>(w) * 3;
    ok = cudaMemcpyAsync(wk->dbuf, rgb, n, cudaMemcpyHostToDevice, wk->stream) ==
             cudaSuccess &&
         nvjpegEncodeImage(g_handle, wk->enc_state, wk->enc_params, &img, NVJPEG_INPUT_RGBI,
                           w, h, wk->stream) == NVJPEG_STATUS_SUCCESS &&
         nvjpegEncodeRetrieveBitstream(g_handle, wk->enc_state, nullptr, &length,
                                       wk->stream) == NVJPEG_STATUS_SUCCESS &&
         cudaStreamSynchronize(wk->stream) == cudaSuccess;
    if (ok) {
      jpeg.resize(length);
      ok = nvjpegEncodeRetrieveBitstream(g_handle, wk->enc_state, jpeg.data(), &length,
                                         wk->stream) == NVJPEG_STATUS_SUCCESS &&
           cudaStreamSynchronize(wk->stream) == cudaSuccess;
    }
  }
  release(wk);
  if (!ok) return kRejected;
  FILE* f = std::fopen(path, "wb");
  if (!f) return kNoFile;
  const bool wrote = std::fwrite(jpeg.data(), 1, length, f) == length;
  return (std::fclose(f) == 0 && wrote) ? kOk : kNoFile;
}

#endif

int decode_one(const char* path, int out_size, unsigned char* out) {
  std::vector<unsigned char> rgb;
  int h = 0, w = 0;
  int rc = decode_raw(path, out_size, rgb, h, w);
  if (rc) return rc;
  resize_bilinear(rgb.data(), h, w, out, out_size);
  return kOk;
}

}  // namespace

extern "C" {

// "libjpeg" or "nvjpeg": the decoder this library was built with.
const char* sgg_decoder_route() { return kRoute; }

// 0 when the decoder can start (nvJPEG: its handle is created).
int sgg_decoder_ready() { return decoder_ready(); }

// Decode+resize one file into out[out_size*out_size*3]. Returns 0 on success.
int sgg_decode_resize_file(const char* path, int out_size, unsigned char* out) {
  return decode_one(path, out_size, out);
}

// The decoded image before the resize (after the prescale for out_size) into
// out[cap], its height and width into *h and *w; 3 when cap is too small
// (*h and *w are set, so the caller can retry with h*w*3 bytes).
int sgg_decode_raw(const char* path, int out_size, unsigned char* out, long cap, int* h,
                   int* w) {
  std::vector<unsigned char> rgb;
  int rc = decode_raw(path, out_size, rgb, *h, *w);
  if (rc) return rc;
  if (static_cast<long>(rgb.size()) > cap) return kTooSmall;
  std::memcpy(out, rgb.data(), rgb.size());
  return kOk;
}

// Encode rgb [h, w, 3] (RGB8) as a baseline 4:2:0 JPEG of the given quality
// at path, with the library's route (sgg_decoder_route). 0 ok, 1 the file
// cannot be written, 2 the encoder rejects the image, 4 it cannot start.
int sgg_encode_file(const char* path, int h, int w, const unsigned char* rgb, int quality) {
  if (h <= 0 || w <= 0 || quality < 1 || quality > 100) return kRejected;
  return encode_file(path, h, w, rgb, quality);
}

// Batch decode n files with a thread pool. out is [n, out_size, out_size, 3].
// status[i] receives the per-file return code. Returns count of failures.
int sgg_decode_batch(const char** paths, int n, int out_size, unsigned char* out, int* status,
                     int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  const size_t stride = static_cast<size_t>(out_size) * out_size * 3;
  std::atomic<int> next(0), failures(0);
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
        int rc = decode_one(paths[i], out_size, out + stride * i);
        status[i] = rc;
        if (rc) failures.fetch_add(1);
      }
    });
  }
  for (auto& th : pool) th.join();
  return failures.load();
}
}
