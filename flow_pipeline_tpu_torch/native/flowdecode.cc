// The port's native frame decoder: length-prefixed FlowMessage protobuf
// frames -> struct-of-arrays columns, in one pass.
//
// A copy of the decode and frame-count part of the JAX package's
// native/flowdecode.cc (same field map, same varint and address rules),
// without its grouping, sketch and encode kernels. Host code, built with
// g++ at first use by flow_pipeline_tpu_torch/native/__init__.py.
//
// C ABI (ctypes):
//   fpt_count_frames(data, len)               -> frames, or -(errpos+1)
//   fpt_decode_stream(data, len, cols, cap)   -> rows, or -(frame+1)
//
// Column pointer layout (schema/batch.py COLUMNS order and widths, then
// ADDR_COLUMNS): 24 scalar columns, then 3 address columns of [N, 4]
// uint32 words (big-endian word order, addresses right-aligned to 16
// bytes). The buffers are zeroed by the caller, so absent fields stay 0.

#include <cstdint>
#include <cstring>

namespace {

enum ScalarCol {
  COL_TYPE = 0,
  COL_TIME_RECEIVED,
  COL_SAMPLING_RATE,
  COL_SEQUENCE_NUM,
  COL_TIME_FLOW_START,
  COL_TIME_FLOW_END,
  COL_BYTES,
  COL_PACKETS,
  COL_SRC_AS,
  COL_DST_AS,
  COL_IN_IF,
  COL_OUT_IF,
  COL_PROTO,
  COL_SRC_PORT,
  COL_DST_PORT,
  COL_IP_TOS,
  COL_FORWARDING_STATUS,
  COL_IP_TTL,
  COL_TCP_FLAGS,
  COL_ETYPE,
  COL_ICMP_TYPE,
  COL_ICMP_CODE,
  COL_IPV6_FLOW_LABEL,
  COL_FLOW_DIRECTION,
  N_SCALAR_COLS
};

// bytes per element of each scalar column (uint64 wire fields keep 8)
constexpr int kColWidth[N_SCALAR_COLS] = {
    4, 8, 8, 4, 8, 8, 8, 8, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
};

enum AddrCol { ADDR_SRC = 0, ADDR_DST, ADDR_SAMPLER, N_ADDR_COLS };

// proto field number -> scalar column (-1: not a scalar field)
int scalar_col_for_field(uint32_t field) {
  switch (field) {
    case 1: return COL_TYPE;
    case 2: return COL_TIME_RECEIVED;
    case 3: return COL_SAMPLING_RATE;
    case 4: return COL_SEQUENCE_NUM;
    case 5: return COL_TIME_FLOW_END;
    case 9: return COL_BYTES;
    case 10: return COL_PACKETS;
    case 14: return COL_SRC_AS;
    case 15: return COL_DST_AS;
    case 18: return COL_IN_IF;
    case 19: return COL_OUT_IF;
    case 20: return COL_PROTO;
    case 21: return COL_SRC_PORT;
    case 22: return COL_DST_PORT;
    case 23: return COL_IP_TOS;
    case 24: return COL_FORWARDING_STATUS;
    case 25: return COL_IP_TTL;
    case 26: return COL_TCP_FLAGS;
    case 30: return COL_ETYPE;
    case 31: return COL_ICMP_TYPE;
    case 32: return COL_ICMP_CODE;
    case 37: return COL_IPV6_FLOW_LABEL;
    case 38: return COL_TIME_FLOW_START;
    case 42: return COL_FLOW_DIRECTION;
    default: return -1;
  }
}

int addr_col_for_field(uint32_t field) {
  switch (field) {
    case 6: return ADDR_SRC;
    case 7: return ADDR_DST;
    case 11: return ADDR_SAMPLER;
    default: return -1;
  }
}

// Parse a varint; false on truncation or more than 10 bytes. Values keep
// their low 64 bits, as canonical parsers (and schema/wire.py) do.
inline bool get_varint(const uint8_t* data, int64_t len, int64_t* pos,
                       uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len) {
    uint8_t b = data[*pos];
    ++*pos;
    if (shift < 64) result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

// A 16-byte (right-aligned) address as 4 big-endian uint32 words; longer
// input keeps its trailing 16 bytes, as schema/batch.py addr_to_words does.
inline void put_addr(uint32_t* dst, const uint8_t* src, int64_t n) {
  uint8_t padded[16] = {0};
  if (n > 16) {
    src += n - 16;
    n = 16;
  }
  std::memcpy(padded + (16 - n), src, static_cast<size_t>(n));
  for (int w = 0; w < 4; ++w) {
    dst[w] = (static_cast<uint32_t>(padded[4 * w]) << 24) |
             (static_cast<uint32_t>(padded[4 * w + 1]) << 16) |
             (static_cast<uint32_t>(padded[4 * w + 2]) << 8) |
             static_cast<uint32_t>(padded[4 * w + 3]);
  }
}

inline void store_scalar(void* col, int width, int64_t row, uint64_t value) {
  if (width == 8) {
    static_cast<uint64_t*>(col)[row] = value;
  } else {
    static_cast<uint32_t*>(col)[row] =
        static_cast<uint32_t>(value & 0xFFFFFFFFu);
  }
}

// One message body into row `row`. Unknown fields are skipped; a field
// whose wire type does not match its schema kind is skipped too.
bool decode_body(const uint8_t* data, int64_t len, void** cols, int64_t row) {
  int64_t pos = 0;
  uint32_t* addr_base[N_ADDR_COLS];
  for (int a = 0; a < N_ADDR_COLS; ++a) {
    addr_base[a] = static_cast<uint32_t*>(cols[N_SCALAR_COLS + a]) + 4 * row;
  }
  while (pos < len) {
    uint64_t tag;
    if (!get_varint(data, len, &pos, &tag)) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wt = static_cast<uint32_t>(tag & 0x7);
    if (wt == 0) {
      uint64_t value;
      if (!get_varint(data, len, &pos, &value)) return false;
      int col = scalar_col_for_field(field);
      if (col >= 0) store_scalar(cols[col], kColWidth[col], row, value);
    } else if (wt == 2) {
      uint64_t blen;
      if (!get_varint(data, len, &pos, &blen)) return false;
      // compared as uint64: a huge length must not wrap the int64 cast
      if (blen > static_cast<uint64_t>(len - pos)) return false;
      int acol = addr_col_for_field(field);
      if (acol >= 0) {
        put_addr(addr_base[acol], data + pos, static_cast<int64_t>(blen));
      }
      pos += static_cast<int64_t>(blen);
    } else if (wt == 5) {
      if (pos + 4 > len) return false;
      pos += 4;
    } else if (wt == 1) {
      if (pos + 8 > len) return false;
      pos += 8;
    } else {
      return false;
    }
  }
  return true;
}

}  // namespace

extern "C" {

long long fpt_count_frames(const char* cdata, long long len) {
  const uint8_t* data = reinterpret_cast<const uint8_t*>(cdata);
  int64_t pos = 0;
  long long frames = 0;
  while (pos < len) {
    uint64_t flen;
    int64_t start = pos;
    if (!get_varint(data, len, &pos, &flen) ||
        flen > static_cast<uint64_t>(len - pos)) {
      return -(start + 1);
    }
    pos += static_cast<int64_t>(flen);
    ++frames;
  }
  return frames;
}

long long fpt_decode_stream(const char* cdata, long long len, void** cols,
                            long long cap) {
  const uint8_t* data = reinterpret_cast<const uint8_t*>(cdata);
  int64_t pos = 0;
  long long row = 0;
  while (pos < len) {
    uint64_t flen;
    if (!get_varint(data, len, &pos, &flen) ||
        flen > static_cast<uint64_t>(len - pos) || row >= cap) {
      return -(row + 1);
    }
    if (!decode_body(data + pos, static_cast<int64_t>(flen), cols, row)) {
      return -(row + 1);
    }
    pos += static_cast<int64_t>(flen);
    ++row;
  }
  return row;
}

}  // extern "C"
