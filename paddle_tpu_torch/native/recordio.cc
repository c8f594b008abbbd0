// Chunked record file format — C++ twin of paddle_tpu/recordio.py.
//
// Parity target: paddle/fluid/recordio/{header.h:42, writer.h:22, scanner.h:26}
// in the reference.  Same on-disk layout as the Python module:
//   header: magic(4) | crc32(4, of compressed payload) | compressor(4) |
//           num_records(4) | payload_len(4)      (all little-endian u32)
//   payload: [len(4) | bytes]* records, optionally zlib-compressed.
// Chunks are independently decodable: fault tolerant, seekable, and
// range-readable for sharded loads (the data-service task unit).
//
// Exposed as a C API (ctypes-friendly); see paddle_tpu/native.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x01020304;
constexpr uint32_t kNoCompress = 0;
constexpr uint32_t kZlibCompress = 2;
constexpr size_t kHeaderSize = 20;

void put_u32(std::string* out, uint32_t v) {
  char b[4] = {char(v & 0xff), char((v >> 8) & 0xff), char((v >> 16) & 0xff),
               char((v >> 24) & 0xff)};
  out->append(b, 4);
}

uint32_t get_u32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Writer
// ---------------------------------------------------------------------------
struct RioWriter {
  FILE* f = nullptr;
  uint32_t compressor = kZlibCompress;
  size_t max_records = 1000;
  size_t max_bytes = 16u << 20;
  std::string payload;   // accumulated [len|bytes]* (uncompressed)
  size_t num_records = 0;
  bool error = false;
};

static void rio_writer_flush_impl(RioWriter* w) {
  if (w->num_records == 0 || w->error) return;
  std::string compressed;
  const std::string* body = &w->payload;
  if (w->compressor == kZlibCompress) {
    uLongf bound = compressBound(w->payload.size());
    compressed.resize(bound);
    if (compress2(reinterpret_cast<Bytef*>(&compressed[0]), &bound,
                  reinterpret_cast<const Bytef*>(w->payload.data()),
                  w->payload.size(), Z_DEFAULT_COMPRESSION) != Z_OK) {
      w->error = true;
      return;
    }
    compressed.resize(bound);
    body = &compressed;
  }
  uint32_t crc = crc32(0L, reinterpret_cast<const Bytef*>(body->data()),
                       body->size());
  std::string header;
  header.reserve(kHeaderSize);
  put_u32(&header, kMagic);
  put_u32(&header, crc);
  put_u32(&header, w->compressor);
  put_u32(&header, static_cast<uint32_t>(w->num_records));
  put_u32(&header, static_cast<uint32_t>(body->size()));
  if (fwrite(header.data(), 1, header.size(), w->f) != header.size() ||
      fwrite(body->data(), 1, body->size(), w->f) != body->size()) {
    w->error = true;
  }
  w->payload.clear();
  w->num_records = 0;
}

RioWriter* rio_writer_open(const char* path, uint32_t compressor,
                           uint64_t max_chunk_records,
                           uint64_t max_chunk_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new RioWriter();
  w->f = f;
  w->compressor = compressor;
  if (max_chunk_records) w->max_records = max_chunk_records;
  if (max_chunk_bytes) w->max_bytes = max_chunk_bytes;
  return w;
}

int rio_writer_write(RioWriter* w, const uint8_t* data, uint64_t len) {
  if (!w || w->error) return -1;
  put_u32(&w->payload, static_cast<uint32_t>(len));
  w->payload.append(reinterpret_cast<const char*>(data), len);
  w->num_records++;
  if (w->num_records >= w->max_records || w->payload.size() >= w->max_bytes) {
    rio_writer_flush_impl(w);
  }
  return w->error ? -1 : 0;
}

int rio_writer_close(RioWriter* w) {
  if (!w) return -1;
  rio_writer_flush_impl(w);
  int rc = w->error ? -1 : 0;
  if (fclose(w->f) != 0) rc = -1;  // final stdio flush can fail (e.g. ENOSPC)
  delete w;
  return rc;
}

// ---------------------------------------------------------------------------
// Scanner (with [chunk_begin, chunk_end) range for sharded reads)
// ---------------------------------------------------------------------------
struct RioScanner {
  FILE* f = nullptr;
  int64_t chunk_begin = 0;
  int64_t chunk_end = -1;  // -1: unbounded
  int64_t chunk_idx = 0;
  std::vector<uint8_t> chunk;  // decompressed current chunk payload
  size_t off = 0;              // read offset into chunk
  size_t remaining = 0;        // records left in current chunk
  std::string error;
};

RioScanner* rio_scanner_open(const char* path, int64_t chunk_begin,
                             int64_t chunk_end) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* s = new RioScanner();
  s->f = f;
  s->chunk_begin = chunk_begin;
  s->chunk_end = chunk_end;
  return s;
}

// Loads the next in-range chunk. Returns 1 on success, 0 on EOF/out-of-range,
// -1 on corruption.
static int rio_load_chunk(RioScanner* s) {
  for (;;) {
    uint8_t head[kHeaderSize];
    if (fread(head, 1, kHeaderSize, s->f) != kHeaderSize) return 0;  // EOF
    uint32_t magic = get_u32(head);
    uint32_t crc = get_u32(head + 4);
    uint32_t comp = get_u32(head + 8);
    uint32_t nrec = get_u32(head + 12);
    uint32_t plen = get_u32(head + 16);
    if (magic != kMagic) {
      s->error = "bad chunk magic";
      return -1;
    }
    if (s->chunk_end >= 0 && s->chunk_idx >= s->chunk_end) return 0;
    if (s->chunk_idx < s->chunk_begin) {
      if (fseek(s->f, plen, SEEK_CUR) != 0) return 0;
      s->chunk_idx++;
      continue;
    }
    s->chunk_idx++;
    std::vector<uint8_t> payload(plen);
    if (fread(payload.data(), 1, plen, s->f) != plen) {
      s->error = "truncated chunk";
      return -1;
    }
    if (crc32(0L, payload.data(), plen) != crc) {
      s->error = "chunk CRC mismatch";
      return -1;
    }
    if (comp == kZlibCompress) {
      // Uncompressed size is not stored; stream-inflate into a growable
      // buffer (single pass regardless of the expansion ratio).
      std::vector<uint8_t> out(plen * 4 + 1024);
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      if (inflateInit(&zs) != Z_OK) {
        s->error = "zlib init failed";
        return -1;
      }
      zs.next_in = payload.data();
      zs.avail_in = plen;
      size_t total = 0;
      int rc;
      do {
        if (total == out.size()) out.resize(out.size() * 2);
        zs.next_out = out.data() + total;
        zs.avail_out = out.size() - total;
        rc = inflate(&zs, Z_NO_FLUSH);
        total = out.size() - zs.avail_out;
      } while (rc == Z_OK);
      inflateEnd(&zs);
      if (rc != Z_STREAM_END) {
        s->error = "zlib decompress failed";
        return -1;
      }
      out.resize(total);
      s->chunk = std::move(out);
    } else {
      s->chunk = std::move(payload);
    }
    s->off = 0;
    s->remaining = nrec;
    return 1;
  }
}

// Returns record length (>=0) with *data pointing into scanner-owned memory
// (valid until the next call), -1 on EOF, -2 on corruption.
int64_t rio_scanner_next(RioScanner* s, const uint8_t** data) {
  if (!s) return -2;
  while (s->remaining == 0) {
    int rc = rio_load_chunk(s);
    if (rc == 0) return -1;
    if (rc < 0) return -2;
  }
  if (s->off + 4 > s->chunk.size()) {
    s->error = "corrupt record length";
    return -2;
  }
  uint32_t rlen = get_u32(s->chunk.data() + s->off);
  s->off += 4;
  if (s->off + rlen > s->chunk.size()) {
    s->error = "corrupt record";
    return -2;
  }
  *data = s->chunk.data() + s->off;
  s->off += rlen;
  s->remaining--;
  return rlen;
}

const char* rio_scanner_error(RioScanner* s) {
  return s ? s->error.c_str() : "null scanner";
}

void rio_scanner_close(RioScanner* s) {
  if (!s) return;
  fclose(s->f);
  delete s;
}

// Number of chunks in a file (master-style task partitioning).
int64_t rio_num_chunks(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t n = 0;
  uint8_t head[kHeaderSize];
  while (fread(head, 1, kHeaderSize, f) == kHeaderSize) {
    uint32_t plen = get_u32(head + 16);
    if (fseek(f, plen, SEEK_CUR) != 0) break;
    n++;
  }
  fclose(f);
  return n;
}

}  // extern "C"
