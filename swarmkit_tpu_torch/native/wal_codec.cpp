// Native WAL frame codec: batch framing + whole-segment validated scans.
//
// The reference keeps its WAL hot path in Go (coreos/etcd/wal encode/decode
// with CRC); this is the equivalent native component for the rebuild's
// host-side runtime.  Frame layout matches raft/storage.py
// (_FRAME = "<II": u32 body length, u32 crc32(body), then the body).
//
// Exposed C ABI (driven from Python via ctypes — see native/__init__.py):
//   wal_frame_size(lens, n)                -> total framed bytes
//   wal_frame(bodies, lens, n, out)        -> bytes written
//   wal_scan(blob, len, offs, lens, max)   -> record count; status via
//                                             wal_scan_status (0 ok,
//                                             1 torn tail dropped,
//                                             2 corrupt mid-stream)

#include <cstdint>
#include <cstring>

namespace {

// slice-by-8 CRC-32 (IEEE 802.3), identical results to zlib.crc32
uint32_t crc_table[8][256];
bool crc_ready = false;

void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[0][i] = c;
    }
    for (int t = 1; t < 8; t++)
        for (uint32_t i = 0; i < 256; i++)
            crc_table[t][i] = crc_table[0][crc_table[t - 1][i] & 0xFF]
                              ^ (crc_table[t - 1][i] >> 8);
    crc_ready = true;
}

uint32_t crc32(const uint8_t* data, uint64_t len) {
    if (!crc_ready) crc_init();
    uint32_t c = 0xFFFFFFFFu;
    while (len >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, data, 4);
        memcpy(&hi, data + 4, 4);
        lo ^= c;
        c = crc_table[7][lo & 0xFF] ^ crc_table[6][(lo >> 8) & 0xFF]
          ^ crc_table[5][(lo >> 16) & 0xFF] ^ crc_table[4][lo >> 24]
          ^ crc_table[3][hi & 0xFF] ^ crc_table[2][(hi >> 8) & 0xFF]
          ^ crc_table[1][(hi >> 16) & 0xFF] ^ crc_table[0][hi >> 24];
        data += 8;
        len -= 8;
    }
    for (uint64_t i = 0; i < len; i++)
        c = crc_table[0][(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

const uint64_t HDR = 8;  // u32 length + u32 crc

void put_u32(uint8_t* p, uint32_t v) {
    p[0] = (uint8_t)(v); p[1] = (uint8_t)(v >> 8);
    p[2] = (uint8_t)(v >> 16); p[3] = (uint8_t)(v >> 24);
}

uint32_t get_u32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8)
         | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

thread_local int g_scan_status = 0;
thread_local uint64_t g_scan_consumed = 0;

}  // namespace

extern "C" {

uint64_t wal_frame_size(const uint64_t* lens, uint64_t n) {
    uint64_t total = 0;
    for (uint64_t i = 0; i < n; i++) total += HDR + lens[i];
    return total;
}

// bodies: concatenated record bodies; lens: per-record lengths.
uint64_t wal_frame(const uint8_t* bodies, const uint64_t* lens, uint64_t n,
                   uint8_t* out) {
    uint64_t in_off = 0, out_off = 0;
    for (uint64_t i = 0; i < n; i++) {
        const uint8_t* body = bodies + in_off;
        put_u32(out + out_off, (uint32_t)lens[i]);
        put_u32(out + out_off + 4, crc32(body, lens[i]));
        memcpy(out + out_off + HDR, body, lens[i]);
        in_off += lens[i];
        out_off += HDR + lens[i];
    }
    return out_off;
}

int wal_scan_status() { return g_scan_status; }

// Bytes consumed by the last wal_scan — lets callers resume a chunked scan
// without pre-allocating worst-case offset arrays.
uint64_t wal_scan_consumed() { return g_scan_consumed; }

// Scans blob, validating CRCs.  Fills offs/lens with body positions.
// Torn frames at the tail are dropped (status 1); a CRC mismatch that is
// NOT the final record is corruption (status 2, scan stops there).
uint64_t wal_scan(const uint8_t* blob, uint64_t len,
                  uint64_t* offs, uint64_t* lens, uint64_t max_records) {
    uint64_t off = 0, count = 0;
    g_scan_status = 0;
    g_scan_consumed = 0;
    while (off < len && count < max_records) {
        if (off + HDR > len) { g_scan_status = 1; break; }
        uint32_t body_len = get_u32(blob + off);
        uint32_t crc = get_u32(blob + off + 4);
        if (off + HDR + body_len > len) { g_scan_status = 1; break; }
        if (crc32(blob + off + HDR, body_len) != crc) {
            // corrupt tail == torn; corrupt mid-stream is fatal
            g_scan_status = (off + HDR + body_len >= len) ? 1 : 2;
            break;
        }
        offs[count] = off + HDR;
        lens[count] = body_len;
        count++;
        off += HDR + body_len;
    }
    g_scan_consumed = off;
    return count;
}

}  // extern "C"
