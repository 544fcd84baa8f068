// JPEG decode and encode on the card through nvJPEG, with a plain C
// interface bound by ctypes (mxnet_tpu_torch/image/codec.py).
//
// Replaces no TPU kernel: the JAX package decodes and encodes on the host
// through cv2 (mxnet_tpu/image/image.py, mxnet_tpu/recordio.py).  The port
// uses this codec where neither cv2 nor PIL imports, and holds it against
// cv2's pixels on the card.  It calls the CUDA toolkit's nvJPEG library
// (linked with -lnvjpeg, a per-source flag of ops/_build.py) for the
// entropy decoding, the inverse DCT and the encoder; its one kernel,
// ycc_to_bgr_kernel, turns the decoded planes into cv2's pixels.
//
// Colour: cv2 decodes with libjpeg(-turbo), which upsamples subsampled
// chroma with its "fancy" triangle filter and converts YCbCr to RGB in
// 16-bit fixed point.  nvJPEG's own interleaved output replicates chroma
// instead, which moves a 4:2:0 image by several gray levels on average.
// So for 4:4:4, 4:2:2 and 4:2:0 streams the decode asks nvJPEG for the
// planes (NVJPEG_OUTPUT_YUV) and ycc_to_bgr_kernel below upsamples and
// converts them with libjpeg's integer arithmetic (jdsample.c
// h2v1/h2v2_fancy_upsample, jdcolor.c ycc_rgb_convert); what remains is
// the difference between the two inverse DCTs.  Other subsamplings take
// nvJPEG's own conversion.  The kernel is bound by the bytes it moves
// (1.5 + 3 bytes a pixel for 4:2:0), far below a microsecond at these
// sizes; the decode's time is nvJPEG's.
//
// Design: one nvjpegHandle_t per process, created once; per calling thread
// a decoder state, an encoder state and parameters, a non-blocking stream
// and a device buffer that grows to the largest image seen, so that
// several host threads (the engine's decode workers, DataLoader threads)
// decode at once without sharing state.  Each call copies its result back
// to the caller's host buffer and synchronizes its own stream before it
// returns: the augmenters that follow compute in numpy on the host.
// Every entry returns 0 on success; otherwise the text of the error is
// read with jpeg_last_error() on the same thread.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdio>
#include <cstring>
#include <mutex>

namespace {

nvjpegHandle_t g_handle = nullptr;
nvjpegStatus_t g_init = NVJPEG_STATUS_SUCCESS;
std::once_flag g_once;

struct ThreadState {
  int device = -1;
  cudaStream_t stream = nullptr;
  nvjpegJpegState_t dec = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  unsigned char* buf = nullptr;
  size_t buf_bytes = 0;
  char err[256] = {0};

  ~ThreadState() {
    // errors are ignored: at process exit the runtime may be gone already
    if (params) nvjpegEncoderParamsDestroy(params);
    if (enc) nvjpegEncoderStateDestroy(enc);
    if (dec) nvjpegJpegStateDestroy(dec);
    if (buf) cudaFree(buf);
    if (stream) cudaStreamDestroy(stream);
  }
};

thread_local ThreadState tls;

int fail(const char* what, int code) {
  std::snprintf(tls.err, sizeof(tls.err), "%s failed with status %d", what,
                code);
  return code == 0 ? -1 : code;
}

#define NVJ(call)                                            \
  do {                                                       \
    nvjpegStatus_t s_ = (call);                              \
    if (s_ != NVJPEG_STATUS_SUCCESS) return fail(#call, s_); \
  } while (0)

#define CUDA(call)                                           \
  do {                                                       \
    cudaError_t e_ = (call);                                 \
    if (e_ != cudaSuccess) return fail(#call, e_);           \
  } while (0)

// The process's handle, and this thread's state on ``device``.
int ready(int device) {
  std::call_once(g_once, [] { g_init = nvjpegCreateSimple(&g_handle); });
  if (g_init != NVJPEG_STATUS_SUCCESS)
    return fail("nvjpegCreateSimple", g_init);
  CUDA(cudaSetDevice(device));
  if (tls.device == device) return 0;
  if (tls.device != -1) {
    std::snprintf(tls.err, sizeof(tls.err),
                  "a thread's codec state is on device %d, not %d",
                  tls.device, device);
    return -1;
  }
  CUDA(cudaStreamCreateWithFlags(&tls.stream, cudaStreamNonBlocking));
  NVJ(nvjpegJpegStateCreate(g_handle, &tls.dec));
  NVJ(nvjpegEncoderStateCreate(g_handle, &tls.enc, tls.stream));
  NVJ(nvjpegEncoderParamsCreate(g_handle, &tls.params, tls.stream));
  tls.device = device;
  return 0;
}

// libjpeg's fixed point (jdcolor.c): SCALEBITS 16, FIX(x) rounded
constexpr int kScaleBits = 16;
constexpr int kHalf = 1 << (kScaleBits - 1);
constexpr int kCrR = 91881;   // FIX(1.40200)
constexpr int kCbB = 116130;  // FIX(1.77200)
constexpr int kCrG = 46802;   // FIX(0.71414)
constexpr int kCbG = 22554;   // FIX(0.34414)

// One chroma sample at output pixel (x, y) of a plane subsampled by
// (hs, vs) in {1, 2}: libjpeg's fancy upsampling, neighbours clamped to
// the plane's edge as its context rows and edge columns are.
__device__ __forceinline__ int chroma(const unsigned char* c, int pitch,
                                      int cw, int ch, int hs, int vs, int x,
                                      int y) {
  if (hs == 1) return c[y * pitch + x];
  int xi = x >> 1;
  int xn = (x & 1) ? min(xi + 1, cw - 1) : max(xi - 1, 0);
  if (vs == 1) {  // h2v1: (3 * near + far + 1 or 2) >> 2
    const unsigned char* row = c + y * pitch;
    return (3 * row[xi] + row[xn] + ((x & 1) ? 2 : 1)) >> 2;
  }
  int yi = y >> 1;
  int yn = (y & 1) ? min(yi + 1, ch - 1) : max(yi - 1, 0);
  const unsigned char* r0 = c + yi * pitch;
  const unsigned char* r1 = c + yn * pitch;
  int here = 3 * r0[xi] + r1[xi];
  int there = 3 * r0[xn] + r1[xn];
  return (3 * here + there + ((x & 1) ? 7 : 8)) >> 4;
}

__device__ __forceinline__ unsigned char clamp255(int v) {
  return static_cast<unsigned char>(min(max(v, 0), 255));
}

__global__ void ycc_to_bgr_kernel(const unsigned char* yp, int ypitch,
                                  const unsigned char* cbp,
                                  const unsigned char* crp, int cpitch,
                                  int cw, int ch, int hs, int vs, int width,
                                  int height, unsigned char* out) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  int luma = yp[y * ypitch + x];
  int cb = chroma(cbp, cpitch, cw, ch, hs, vs, x, y) - 128;
  int cr = chroma(crp, cpitch, cw, ch, hs, vs, x, y) - 128;
  unsigned char* o = out + 3 * (static_cast<size_t>(y) * width + x);
  o[0] = clamp255(luma + ((kCbB * cb + kHalf) >> kScaleBits));
  o[1] = clamp255(luma + ((-kCbG * cb + kHalf - kCrG * cr) >> kScaleBits));
  o[2] = clamp255(luma + ((kCrR * cr + kHalf) >> kScaleBits));
}

int reserve(size_t bytes) {
  if (bytes <= tls.buf_bytes) return 0;
  if (tls.buf) CUDA(cudaFree(tls.buf));
  tls.buf = nullptr;
  tls.buf_bytes = 0;
  CUDA(cudaMalloc(&tls.buf, bytes));
  tls.buf_bytes = bytes;
  return 0;
}

}  // namespace

extern "C" {

const char* jpeg_last_error() { return tls.err; }

// Components, width, height and chroma subsampling (nvjpegChromaSubsampling_t)
// of a JPEG stream.
int jpeg_info(const unsigned char* data, size_t len, int* comps, int* width,
              int* height, int* subsampling) {
  std::call_once(g_once, [] { g_init = nvjpegCreateSimple(&g_handle); });
  if (g_init != NVJPEG_STATUS_SUCCESS)
    return fail("nvjpegCreateSimple", g_init);
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t css;
  NVJ(nvjpegGetImageInfo(g_handle, data, len, comps, &css, widths, heights));
  *width = widths[0];
  *height = heights[0];
  *subsampling = static_cast<int>(css);
  return 0;
}

// Decode into device memory, then copy the height x width image to ``out``
// on the host: interleaved BGR (cv2's channel order) when ``gray`` is 0,
// the luma plane when it is 1.  4:4:4, 4:2:2 and 4:2:0 colour is
// converted with libjpeg's arithmetic (ycc_to_bgr_kernel); other
// subsamplings take nvJPEG's own interleaved output.
int jpeg_decode(int device, const unsigned char* data, size_t len, int gray,
                int width, int height, unsigned char* out) {
  int rc = ready(device);
  if (rc) return rc;
  int comps = 0, widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t css;
  NVJ(nvjpegGetImageInfo(g_handle, data, len, &comps, &css, widths,
                         heights));
  int hs = 0, vs = 0;
  if (css == NVJPEG_CSS_444) hs = 1, vs = 1;
  if (css == NVJPEG_CSS_422) hs = 2, vs = 1;
  if (css == NVJPEG_CSS_420) hs = 2, vs = 2;
  size_t pix = static_cast<size_t>(width) * height;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  if (gray || comps != 3 || hs == 0) {
    size_t channels = gray ? 1 : 3;
    rc = reserve(channels * pix);
    if (rc) return rc;
    img.channel[0] = tls.buf;
    img.pitch[0] = channels * width;
    NVJ(nvjpegDecode(g_handle, tls.dec, data, len,
                     gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_BGRI, &img,
                     tls.stream));
    CUDA(cudaMemcpyAsync(out, tls.buf, channels * pix,
                         cudaMemcpyDeviceToHost, tls.stream));
    CUDA(cudaStreamSynchronize(tls.stream));
    return 0;
  }
  int cw = widths[1], ch = heights[1];
  size_t cbytes = static_cast<size_t>(cw) * ch;
  rc = reserve(pix + 2 * cbytes + 3 * pix);
  if (rc) return rc;
  unsigned char* bgr = tls.buf + pix + 2 * cbytes;
  img.channel[0] = tls.buf;
  img.pitch[0] = width;
  img.channel[1] = tls.buf + pix;
  img.pitch[1] = cw;
  img.channel[2] = tls.buf + pix + cbytes;
  img.pitch[2] = cw;
  NVJ(nvjpegDecode(g_handle, tls.dec, data, len, NVJPEG_OUTPUT_YUV, &img,
                   tls.stream));
  dim3 block(32, 8);
  dim3 grid((width + 31) / 32, (height + 7) / 8);
  ycc_to_bgr_kernel<<<grid, block, 0, tls.stream>>>(
      img.channel[0], width, img.channel[1], img.channel[2], cw, cw, ch, hs,
      vs, width, height, bgr);
  CUDA(cudaGetLastError());
  CUDA(cudaMemcpyAsync(out, bgr, 3 * pix, cudaMemcpyDeviceToHost,
                       tls.stream));
  CUDA(cudaStreamSynchronize(tls.stream));
  return 0;
}

// The decoded planes of a 3-component stream, copied to the host: the
// height x width luma plane ``y`` and the chroma planes ``cb`` and ``cr``
// at their stored size (``cw`` x ``ch``), before any upsampling: the
// input of ycc_to_bgr_kernel, for holding it to its plain version.
int jpeg_decode_planes(int device, const unsigned char* data, size_t len,
                       int width, int height, int cw, int ch,
                       unsigned char* y, unsigned char* cb,
                       unsigned char* cr) {
  int rc = ready(device);
  if (rc) return rc;
  size_t pix = static_cast<size_t>(width) * height;
  size_t cbytes = static_cast<size_t>(cw) * ch;
  rc = reserve(pix + 2 * cbytes);
  if (rc) return rc;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = tls.buf;
  img.pitch[0] = width;
  img.channel[1] = tls.buf + pix;
  img.pitch[1] = cw;
  img.channel[2] = tls.buf + pix + cbytes;
  img.pitch[2] = cw;
  NVJ(nvjpegDecode(g_handle, tls.dec, data, len, NVJPEG_OUTPUT_YUV, &img,
                   tls.stream));
  CUDA(cudaMemcpyAsync(y, img.channel[0], pix, cudaMemcpyDeviceToHost,
                       tls.stream));
  CUDA(cudaMemcpyAsync(cb, img.channel[1], cbytes, cudaMemcpyDeviceToHost,
                       tls.stream));
  CUDA(cudaMemcpyAsync(cr, img.channel[2], cbytes, cudaMemcpyDeviceToHost,
                       tls.stream));
  CUDA(cudaStreamSynchronize(tls.stream));
  return 0;
}

// Encode a height x width host image (interleaved BGR when ``channels`` is 3,
// one luma plane when it is 1) at ``quality`` with chroma ``subsampling``
// (0: 4:4:4, 1: 4:2:2, 2: 4:2:0; ignored for one channel) into ``out``,
// which holds ``capacity`` bytes.  ``*out_len`` is the stream's length;
// when it exceeds ``capacity`` nothing is copied and -2 is returned.
int jpeg_encode(int device, const unsigned char* src, int width, int height,
                int channels, int quality, int subsampling,
                unsigned char* out, size_t capacity, size_t* out_len) {
  int rc = ready(device);
  if (rc) return rc;
  if (channels != 1 && channels != 3) {
    std::snprintf(tls.err, sizeof(tls.err),
                  "nvJPEG encodes 1 or 3 channels, not %d", channels);
    return -1;
  }
  if (subsampling < 0 || subsampling > 2) {
    std::snprintf(tls.err, sizeof(tls.err),
                  "subsampling code %d is not 0, 1 or 2", subsampling);
    return -1;
  }
  size_t pitch = static_cast<size_t>(channels) * width;
  size_t bytes = pitch * static_cast<size_t>(height);
  rc = reserve(bytes);
  if (rc) return rc;
  CUDA(cudaMemcpyAsync(tls.buf, src, bytes, cudaMemcpyHostToDevice,
                       tls.stream));
  const nvjpegChromaSubsampling_t css[3] = {NVJPEG_CSS_444, NVJPEG_CSS_422,
                                            NVJPEG_CSS_420};
  nvjpegChromaSubsampling_t want =
      channels == 1 ? NVJPEG_CSS_GRAY : css[subsampling];
  NVJ(nvjpegEncoderParamsSetQuality(tls.params, quality, tls.stream));
  NVJ(nvjpegEncoderParamsSetOptimizedHuffman(tls.params, 0, tls.stream));
  NVJ(nvjpegEncoderParamsSetSamplingFactors(tls.params, want, tls.stream));
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = tls.buf;
  img.pitch[0] = pitch;
  if (channels == 3) {
    NVJ(nvjpegEncodeImage(g_handle, tls.enc, tls.params, &img,
                          NVJPEG_INPUT_BGRI, width, height, tls.stream));
  } else {
    NVJ(nvjpegEncodeYUV(g_handle, tls.enc, tls.params, &img,
                        NVJPEG_CSS_GRAY, width, height, tls.stream));
  }
  size_t length = 0;
  NVJ(nvjpegEncodeRetrieveBitstream(g_handle, tls.enc, nullptr, &length,
                                    tls.stream));
  CUDA(cudaStreamSynchronize(tls.stream));
  *out_len = length;
  if (length > capacity) return -2;
  NVJ(nvjpegEncodeRetrieveBitstream(g_handle, tls.enc, out, &length,
                                    tls.stream));
  CUDA(cudaStreamSynchronize(tls.stream));
  *out_len = length;
  return 0;
}

}  // extern "C"
