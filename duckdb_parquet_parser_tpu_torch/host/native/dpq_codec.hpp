// dpq_codec.hpp — page-payload codec dispatch (engine extension).
//
// The reference rejects every codec but UNCOMPRESSED
// (reference: src/reader/column_reader.cpp:13-15); the engine reads and
// writes the compressed Parquet files found in the wild.  SNAPPY is
// implemented in-tree (dpq_snappy.hpp); GZIP/ZSTD use the system zlib /
// libzstd (dev headers present); LZ4 and BROTLI bind the system runtime
// libraries directly with prototypes declared below — the image ships their
// .so.1 runtimes without dev headers, and the stable public ABIs are tiny.
//
// Availability is compile-time gated (DPQ_HAVE_*) by host/build.py and
// CMakeLists.txt probing, so the library still builds on a machine without
// the libraries — those codecs then report unsupported, like the reference
// does for everything.
//
// Codec formats (all cross-checked against pyarrow in tests/test_codecs.py):
//   GZIP    — full RFC-1952 gzip members; decode accepts multi-member
//             concatenation (Hadoop writers emit those) and bare zlib.
//   ZSTD    — single zstd frame.
//   LZ4_RAW — one raw LZ4 block (what modern writers emit; codec id 7).
//   LZ4     — the legacy Hadoop framing ([u32be usize][u32be csize][block]…),
//             with a raw-block fallback on structural mismatch, mirroring
//             arrow's Lz4HadoopCodec compatibility behavior (codec id 5).
//   BROTLI  — single brotli stream.
#pragma once

#include <cstring>
#include <string>
#include <vector>

#include "dpq_common.hpp"
#include "dpq_snappy.hpp"

#ifdef DPQ_HAVE_ZLIB
#include <zlib.h>
#endif
#ifdef DPQ_HAVE_ZSTD
#include <zstd.h>
#endif

#ifdef DPQ_HAVE_LZ4
extern "C" {
int LZ4_decompress_safe(const char* src, char* dst, int csize, int dcap);
int LZ4_compress_default(const char* src, char* dst, int ssize, int dcap);
int LZ4_compressBound(int size);
}
#endif

#ifdef DPQ_HAVE_BROTLI
extern "C" {
// BrotliDecoderResult: 0=error, 1=success, 2/3=needs more input/output.
int BrotliDecoderDecompress(size_t encoded_size, const uint8_t* encoded,
                            size_t* decoded_size, uint8_t* decoded);
// Returns BROTLI_BOOL (1 on success).  mode 0 = BROTLI_MODE_GENERIC.
int BrotliEncoderCompress(int quality, int lgwin, int mode, size_t input_size,
                          const uint8_t* input, size_t* encoded_size,
                          uint8_t* encoded);
size_t BrotliEncoderMaxCompressedSize(size_t input_size);
}
#endif

namespace dpq {

inline bool codec_supported(int32_t c) {
  switch (c) {
    case C_UNCOMPRESSED:
    case C_SNAPPY:
      return true;
#ifdef DPQ_HAVE_ZLIB
    case C_GZIP:
      return true;
#endif
#ifdef DPQ_HAVE_ZSTD
    case C_ZSTD:
      return true;
#endif
#ifdef DPQ_HAVE_LZ4
    case C_LZ4:
    case C_LZ4_RAW:
      return true;
#endif
#ifdef DPQ_HAVE_BROTLI
    case C_BROTLI:
      return true;
#endif
    default:
      return false;
  }
}

inline std::string codec_supported_list() {
  std::string s = "UNCOMPRESSED, SNAPPY";
#ifdef DPQ_HAVE_ZLIB
  s += ", GZIP";
#endif
#ifdef DPQ_HAVE_ZSTD
  s += ", ZSTD";
#endif
#ifdef DPQ_HAVE_LZ4
  s += ", LZ4, LZ4_RAW";
#endif
#ifdef DPQ_HAVE_BROTLI
  s += ", BROTLI";
#endif
  return s;
}

#ifdef DPQ_HAVE_ZLIB
inline void gzip_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                            size_t dst_len) {
  if (n == 0) {
    if (dst_len != 0) throw Error("gzip: empty payload");
    return;
  }
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // 15+32: auto-detect gzip or zlib headers.
  if (inflateInit2(&zs, 15 + 32) != Z_OK) throw Error("gzip: inflateInit");
  zs.next_in = const_cast<Bytef*>(reinterpret_cast<const Bytef*>(src));
  zs.avail_in = static_cast<uInt>(n);
  zs.next_out = reinterpret_cast<Bytef*>(dst);
  zs.avail_out = static_cast<uInt>(dst_len);
  bool ended = false;
  for (;;) {
    int ret = inflate(&zs, Z_NO_FLUSH);
    if (ret == Z_STREAM_END) {
      if (zs.avail_in == 0) {
        ended = true;
        break;
      }
      // Concatenated gzip members: reset stream state, keep the cursors.
      if (inflateReset2(&zs, 15 + 32) != Z_OK) break;
      continue;
    }
    if (ret != Z_OK) break;   // data error or stalled (Z_BUF_ERROR)
    if (zs.avail_in == 0) break;  // input consumed without stream end
  }
  const bool exact = ended && zs.avail_out == 0;
  inflateEnd(&zs);
  if (!exact) throw Error("gzip: corrupt stream or length mismatch");
}

inline std::vector<uint8_t> gzip_compress(const uint8_t* src, size_t n) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // 15+16: emit the gzip container (what Parquet's GZIP codec stores).
  if (deflateInit2(&zs, Z_DEFAULT_COMPRESSION, Z_DEFLATED, 15 + 16, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK)
    throw Error("gzip: deflateInit");
  std::vector<uint8_t> out(deflateBound(&zs, static_cast<uLong>(n)));
  zs.next_in = const_cast<Bytef*>(reinterpret_cast<const Bytef*>(src));
  zs.avail_in = static_cast<uInt>(n);
  zs.next_out = out.data();
  zs.avail_out = static_cast<uInt>(out.size());
  int ret = deflate(&zs, Z_FINISH);
  const size_t produced = out.size() - zs.avail_out;
  deflateEnd(&zs);
  if (ret != Z_STREAM_END) throw Error("gzip: deflate failed");
  out.resize(produced);
  return out;
}
#endif  // DPQ_HAVE_ZLIB

#ifdef DPQ_HAVE_ZSTD
inline void zstd_decompress_page(const uint8_t* src, size_t n, uint8_t* dst,
                                 size_t dst_len) {
  size_t r = ZSTD_decompress(dst, dst_len, src, n);
  if (ZSTD_isError(r))
    throw Error(std::string("zstd: ") + ZSTD_getErrorName(r));
  if (r != dst_len) throw Error("zstd: length mismatch with page header");
}

inline std::vector<uint8_t> zstd_compress_page(const uint8_t* src, size_t n) {
  std::vector<uint8_t> out(ZSTD_compressBound(n));
  size_t r = ZSTD_compress(out.data(), out.size(), src, n, /*level=*/1);
  if (ZSTD_isError(r))
    throw Error(std::string("zstd: ") + ZSTD_getErrorName(r));
  out.resize(r);
  return out;
}
#endif  // DPQ_HAVE_ZSTD

#ifdef DPQ_HAVE_LZ4
inline void lz4_raw_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                               size_t dst_len) {
  if (n == 0 && dst_len == 0) return;
  int r = LZ4_decompress_safe(reinterpret_cast<const char*>(src),
                              reinterpret_cast<char*>(dst),
                              static_cast<int>(n), static_cast<int>(dst_len));
  if (r < 0 || static_cast<size_t>(r) != dst_len)
    throw Error("lz4: corrupt block or length mismatch");
}

// Hadoop framing: repeated [u32be uncompressed][u32be compressed][block]…
// (the inner loop allows several compressed blocks per outer size, as
// Hadoop's BlockCompressorStream emits).  Returns false on any structural
// mismatch so the caller can retry as a raw block.
inline bool lz4_hadoop_try(const uint8_t* src, size_t n, uint8_t* dst,
                           size_t dst_len) {
  auto be32 = [](const uint8_t* p) -> uint32_t {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
  };
  size_t ip = 0, op = 0;
  while (ip < n) {
    if (ip + 8 > n) return false;
    uint32_t usz = be32(src + ip);
    ip += 4;
    if (op + usz > dst_len) return false;
    size_t produced = 0;
    while (produced < usz) {
      if (ip + 4 > n) return false;
      uint32_t csz = be32(src + ip);
      ip += 4;
      if (csz == 0 || ip + csz > n) return false;
      int r = LZ4_decompress_safe(
          reinterpret_cast<const char*>(src + ip),
          reinterpret_cast<char*>(dst + op + produced), static_cast<int>(csz),
          static_cast<int>(usz - produced));
      if (r <= 0) return false;
      produced += static_cast<size_t>(r);
      ip += csz;
    }
    if (produced != usz) return false;
    op += usz;
  }
  return op == dst_len;
}

inline void lz4_hadoop_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                                  size_t dst_len) {
  if (n == 0 && dst_len == 0) return;
  if (lz4_hadoop_try(src, n, dst, dst_len)) return;
  lz4_raw_decompress(src, n, dst, dst_len);  // arrow-style raw fallback
}

inline std::vector<uint8_t> lz4_raw_compress(const uint8_t* src, size_t n) {
  std::vector<uint8_t> out(
      static_cast<size_t>(LZ4_compressBound(static_cast<int>(n))));
  int r = LZ4_compress_default(reinterpret_cast<const char*>(src),
                               reinterpret_cast<char*>(out.data()),
                               static_cast<int>(n),
                               static_cast<int>(out.size()));
  if (r <= 0 && n > 0) throw Error("lz4: compress failed");
  out.resize(static_cast<size_t>(r > 0 ? r : 0));
  return out;
}

inline std::vector<uint8_t> lz4_hadoop_compress(const uint8_t* src, size_t n) {
  std::vector<uint8_t> block = lz4_raw_compress(src, n);
  std::vector<uint8_t> out;
  out.reserve(block.size() + 8);
  auto put_be32 = [&out](uint32_t v) {
    out.push_back(uint8_t(v >> 24));
    out.push_back(uint8_t(v >> 16));
    out.push_back(uint8_t(v >> 8));
    out.push_back(uint8_t(v));
  };
  put_be32(static_cast<uint32_t>(n));
  put_be32(static_cast<uint32_t>(block.size()));
  out.insert(out.end(), block.begin(), block.end());
  return out;
}
#endif  // DPQ_HAVE_LZ4

#ifdef DPQ_HAVE_BROTLI
inline void brotli_decompress_page(const uint8_t* src, size_t n, uint8_t* dst,
                                   size_t dst_len) {
  size_t dsz = dst_len;
  if (BrotliDecoderDecompress(n, src, &dsz, dst) != 1 || dsz != dst_len)
    throw Error("brotli: corrupt stream or length mismatch");
}

inline std::vector<uint8_t> brotli_compress_page(const uint8_t* src,
                                                 size_t n) {
  size_t cap = BrotliEncoderMaxCompressedSize(n);
  if (cap == 0) cap = n + 512;
  std::vector<uint8_t> out(cap);
  size_t esz = cap;
  // quality 5 / lgwin 22: pages are ~1 KB, ratio plateaus well before q=11.
  if (!BrotliEncoderCompress(5, 22, 0, n, src, &esz, out.data()))
    throw Error("brotli: compress failed");
  out.resize(esz);
  return out;
}
#endif  // DPQ_HAVE_BROTLI

// Decompress a page payload of known decoded size (Parquet page headers
// carry uncompressed_page_size, so every codec path is exact-length).
inline void codec_decompress(int32_t codec, const uint8_t* src, size_t n,
                             uint8_t* dst, size_t dst_len) {
  switch (codec) {
    case C_SNAPPY:
      snappy_decompress(src, n, dst, dst_len);
      return;
#ifdef DPQ_HAVE_ZLIB
    case C_GZIP:
      gzip_decompress(src, n, dst, dst_len);
      return;
#endif
#ifdef DPQ_HAVE_ZSTD
    case C_ZSTD:
      zstd_decompress_page(src, n, dst, dst_len);
      return;
#endif
#ifdef DPQ_HAVE_LZ4
    case C_LZ4:
      lz4_hadoop_decompress(src, n, dst, dst_len);
      return;
    case C_LZ4_RAW:
      lz4_raw_decompress(src, n, dst, dst_len);
      return;
#endif
#ifdef DPQ_HAVE_BROTLI
    case C_BROTLI:
      brotli_decompress_page(src, n, dst, dst_len);
      return;
#endif
    default:
      throw Error(std::string("unsupported codec ") + compression_name(codec) +
                  " (supported: " + codec_supported_list() + ")");
  }
}

inline std::vector<uint8_t> codec_compress(int32_t codec, const uint8_t* src,
                                           size_t n) {
  switch (codec) {
    case C_SNAPPY:
      return snappy_compress(src, n);
#ifdef DPQ_HAVE_ZLIB
    case C_GZIP:
      return gzip_compress(src, n);
#endif
#ifdef DPQ_HAVE_ZSTD
    case C_ZSTD:
      return zstd_compress_page(src, n);
#endif
#ifdef DPQ_HAVE_LZ4
    case C_LZ4:
      return lz4_hadoop_compress(src, n);
    case C_LZ4_RAW:
      return lz4_raw_compress(src, n);
#endif
#ifdef DPQ_HAVE_BROTLI
    case C_BROTLI:
      return brotli_compress_page(src, n);
#endif
    default:
      throw Error(std::string("unsupported codec ") + compression_name(codec) +
                  " (supported: " + codec_supported_list() + ")");
  }
}

}  // namespace dpq
