// Native host tier of theora_tpu_torch.
//
// Copy of the parts of theora_tpu/native/entropy.cpp the port runs. Decode:
// the Huffman context, residual-token decode and replay
// (decode.c:1141-1586), DC prediction (decode.c:1392-1500) and the frame
// side-info parser (decode.c:442-981). Encode (the device GOP encoder's
// host stages): DC prediction residuals (tokenize.c:977-1074), the token
// packer (tokenize + Huffman selection + residual section,
// encode.c:816-863), the coded-flags and MB-mode packers
// (encode.c:487-621) and the sequential mode decision of the GOP encoder;
// the host encoder's keyframe path: fDCT + R/D quantization, the trellis
// planner (tokenize.c:457-744) and the packer of its plans; its inter
// path: luma motion estimation, the mode decision with its fragment fill,
// the batch SAD, the MC residual gather and the uncoded SSD.
// Bit-serial work stays on the host; the pixel pipeline runs on the card.
//
// Pure C ABI (loaded via ctypes). No Python.h dependency.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- bit I/O
struct BitReader {
  const uint8_t* data;
  int64_t nbits;
  int64_t pos;
  bool eof;

  void init(const uint8_t* d, int64_t nbytes) {
    data = d;
    nbits = nbytes * 8;
    pos = 0;
    eof = false;
  }
  // Word-based MSB-first window: up to 32 bits in one 64-bit load
  // (zero-padded past EOF, bitpack.c:30-70 semantics).
  uint32_t window(int bits) const {
    int64_t byte0 = pos >> 3;
    int off = (int)(pos & 7);
    uint64_t w = 0;
    int64_t navail = (nbits + 7) >> 3;
    if (byte0 + 8 <= navail) {
      w = ((uint64_t)data[byte0] << 56) | ((uint64_t)data[byte0 + 1] << 48) |
          ((uint64_t)data[byte0 + 2] << 40) |
          ((uint64_t)data[byte0 + 3] << 32) |
          ((uint64_t)data[byte0 + 4] << 24) |
          ((uint64_t)data[byte0 + 5] << 16) |
          ((uint64_t)data[byte0 + 6] << 8) | (uint64_t)data[byte0 + 7];
    } else {
      for (int i = 0; i < 8; i++) {
        uint64_t b = (byte0 + i < navail) ? data[byte0 + i] : 0;
        w |= b << (56 - 8 * i);
      }
    }
    uint32_t v = (uint32_t)((w << off) >> (64 - bits));
    // Zero any bits past nbits (trailing byte padding must read as 0).
    int64_t valid = nbits - pos;
    if (valid < bits) {
      if (valid <= 0) return 0;
      v &= ~0u << (bits - (int)valid);
    }
    return v;
  }
  uint32_t read(int bits) {
    if (bits == 0) return 0;
    uint32_t v = bits <= 32 ? window(bits) : 0;
    if (bits > 32) {
      for (int i = 0; i < bits; i++) {
        int64_t p = pos + i;
        int b = (p < nbits) ? ((data[p >> 3] >> (7 - (p & 7))) & 1) : 0;
        v = (v << 1) | (uint32_t)b;
      }
      pos += bits;
      if (pos > nbits) eof = true;
      return v;
    }
    pos += bits;
    if (pos > nbits) eof = true;
    return v;
  }
  uint32_t peek(int bits) const { return window(bits); }
};

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t cur = 0;
  int curbits = 0;

  void write(uint32_t value, int bits) {
    if (bits <= 0) return;
    cur = (cur << bits) | (value & ((bits >= 32) ? 0xFFFFFFFFu : ((1u << bits) - 1)));
    curbits += bits;
    while (curbits >= 8) {
      curbits -= 8;
      buf.push_back((uint8_t)((cur >> curbits) & 0xFF));
    }
    cur &= (1ull << curbits) - 1;
  }
  void flush() {
    if (curbits) {
      buf.push_back((uint8_t)((cur << (8 - curbits)) & 0xFF));
      cur = 0;
      curbits = 0;
    }
  }
};

// ------------------------------------------------------------- Huffman LUT
// Two-level LUT per codebook: root ROOT_BITS wide; entries:
//   >0: ((nbits<<8)|token)+1 for short codes
//   <0: -(index into long-code chain start)  [handled linearly: rare]
constexpr int ROOT_BITS = 10;

struct Codebook {
  int32_t lut[1 << ROOT_BITS];   // packed as above; 0 = long code
  // Long codes (len > ROOT_BITS): linear list.
  struct Long { uint32_t pattern; int nbits; int token; };
  std::vector<Long> longs;

  int decode(BitReader& br) const {
    uint32_t p = br.peek(ROOT_BITS);
    int32_t e = lut[p];
    if (e) {
      e -= 1;
      br.pos += (e >> 8);
      if (br.pos > br.nbits) { /* virtual zero bits consumed */ }
      return e & 0xFF;
    }
    // Long code: extend bit by bit.
    uint32_t code = p;
    int nb = ROOT_BITS;
    while (nb < 33) {
      for (const Long& L : longs)
        if (L.nbits == nb && L.pattern == code) {
          br.pos += nb;
          return L.token;
        }
      int64_t q = br.pos + nb;
      int b = (q < br.nbits) ? ((br.data[q >> 3] >> (7 - (q & 7))) & 1) : 0;
      code = (code << 1) | (uint32_t)b;
      nb++;
    }
    return -1;
  }
};

// Extra bits per spec token (internal.c:82-95).
const int TOKEN_EB[32] = {0, 0, 0, 2, 3, 4, 12, 3, 6, 0, 0, 0, 0,
                          1, 1, 1, 1, 2, 3, 4, 5, 6, 10,
                          1, 1, 1, 1, 1, 3, 4, 2, 3};

constexpr int64_t EOB_FINISH = 1ll << 60;

// token+eb -> (eobs, rlen, coeff); see theora_tpu/huffman.py expand_token.
inline void expand_token(int t, int eb, int64_t* eobs, int* rlen, int* coeff) {
  *eobs = 0; *rlen = 0; *coeff = 0;
  if (t < 3) { *eobs = t + 1; return; }
  if (t == 3) { *eobs = 4 + eb; return; }
  if (t == 4) { *eobs = 8 + eb; return; }
  if (t == 5) { *eobs = 16 + eb; return; }
  if (t == 6) { *eobs = eb ? eb : EOB_FINISH; return; }
  if (t == 7 || t == 8) { *rlen = eb; return; }
  if (t < 13) { static const int v[4] = {1, -1, 2, -2}; *coeff = v[t - 9]; return; }
  if (t < 17) { int m = 3 + t - 13; *coeff = eb ? -m : m; return; }
  if (t < 23) {
    static const int nb[6] = {1, 2, 3, 4, 5, 9};
    static const int base[6] = {7, 9, 13, 21, 37, 69};
    int k = t - 17;
    int m = base[k] + (eb & ((1 << nb[k]) - 1));
    *coeff = (eb >> nb[k]) ? -m : m;
    return;
  }
  if (t < 28) { *rlen = t - 22; *coeff = eb ? -1 : 1; return; }
  if (t == 28) { *rlen = 6 + (eb & 3); *coeff = (eb >> 2) ? -1 : 1; return; }
  if (t == 29) { *rlen = 10 + (eb & 7); *coeff = (eb >> 3) ? -1 : 1; return; }
  if (t == 30) { int m = 2 + (eb & 1); *rlen = 1; *coeff = (eb >> 1) ? -m : m; return; }
  int m = 2 + ((eb >> 1) & 1);
  *rlen = 2 + (eb & 1);
  *coeff = (eb >> 2) ? -m : m;
}

const int HUFF_LIST_MAX[5] = {1, 6, 15, 28, 64};

struct Ctx {
  Codebook books[80];
};

}  // namespace

extern "C" {

// codes: [80][32][3] int32 (token, pattern, nbits); entries with nbits==0
// and token<0 unused. ncodes[80]: number of codes per book.
void* th_entropy_create(const int32_t* codes, const int32_t* ncodes) {
  Ctx* ctx = new Ctx();
  for (int b = 0; b < 80; b++) {
    Codebook& cb = ctx->books[b];
    memset(cb.lut, 0, sizeof(cb.lut));
    for (int i = 0; i < ncodes[b]; i++) {
      const int32_t* c = codes + (b * 32 + i) * 3;
      int token = c[0];
      uint32_t pattern = (uint32_t)c[1];
      int nbits = c[2];
      if (nbits <= ROOT_BITS) {
        uint32_t base = pattern << (ROOT_BITS - nbits);
        int32_t entry = ((nbits << 8) | token) + 1;
        for (uint32_t k = 0; k < (1u << (ROOT_BITS - nbits)); k++)
          cb.lut[base + k] = entry;
      } else {
        cb.longs.push_back({pattern, nbits, token});
      }
    }
  }
  return ctx;
}

void th_entropy_destroy(void* p) { delete (Ctx*)p; }

// Decode all residual tokens of a frame and replay them into per-fragment
// zig-zag coefficient rows.
//
// Inputs:
//   packet/packet_len: the frame packet; bit_offset: position of the
//     residual-token section (after qi RLE).
//   ncoded[3]: coded fragment counts per plane.
// Outputs:
//   qcoeffs: [total, 64] int16 quantized coefficients at final zig-zag
//     positions (DC slot = raw DC token value, pre-prediction).
//   last_zzi: [total] int32.
//   dc: [total] int32 (pre-prediction DC values, coded order).
// Returns final bit position, or -1 on error.
int64_t th_decode_frame_tokens(
    void* pctx, const uint8_t* packet, int64_t packet_len, int64_t bit_offset,
    const int64_t* ncoded, int16_t* qcoeffs, int32_t* last_zzi, int32_t* dc,
    int32_t* frag_bits) {
  Ctx* ctx = (Ctx*)pctx;
  BitReader br;
  br.init(packet, packet_len);
  br.pos = bit_offset;
  int64_t total = ncoded[0] + ncoded[1] + ncoded[2];
  memset(qcoeffs, 0, sizeof(int16_t) * total * 64);
  memset(dc, 0, sizeof(int32_t) * total);

  // Token streams: store per (pli, zzi).
  std::vector<uint8_t> toks[3][64];
  std::vector<int32_t> ebs[3][64];
  std::vector<int32_t> tbits[3][64];  // per-token bit lengths (telemetry)
  if (frag_bits) memset(frag_bits, 0, sizeof(int32_t) * total);
  int64_t eob_start[3][64];
  int64_t ntoks_left[3][64];
  for (int pli = 0; pli < 3; pli++)
    for (int z = 0; z < 64; z++) ntoks_left[pli][z] = ncoded[pli];

  // ---- DC tokens ----
  int huff[2];
  huff[0] = br.read(4);
  huff[1] = br.read(4);
  int64_t eobs = 0;
  int64_t frag_base = 0;
  for (int pli = 0; pli < 3; pli++) {
    const Codebook& book = ctx->books[huff[(pli + 1) >> 1]];
    int64_t run_counts[64] = {0};
    eob_start[pli][0] = eobs;
    int64_t n = ncoded[pli];
    int64_t fragii = 0;
    int64_t eobi = eobs < n ? eobs : n;
    int64_t eob_count = eobi;
    eobs -= eobi;
    fragii += eobi;
    while (fragii < n) {
      int64_t p0 = br.pos;
      int t = book.decode(br);
      if (t < 0) return -1;
      int eb = TOKEN_EB[t] ? (int)br.read(TOKEN_EB[t]) : 0;
      toks[pli][0].push_back((uint8_t)t);
      ebs[pli][0].push_back(eb);
      if (frag_bits) tbits[pli][0].push_back((int32_t)(br.pos - p0));
      int64_t te; int rl, cf;
      expand_token(t, eb, &te, &rl, &cf);
      if (te) {
        eobi = te < n - fragii ? te : n - fragii;
        eob_count += eobi;
        eobs = te - eobi;
        fragii += eobi;
      } else {
        run_counts[rl]++;
        dc[frag_base + fragii] = rl ? 0 : cf;
        fragii++;
      }
    }
    run_counts[63] += eob_count;
    int64_t acc = 0;
    for (int r = 63; r >= 0; r--) {
      acc += run_counts[r];
      ntoks_left[pli][r] -= acc;
    }
    frag_base += n;
  }

  // ---- AC tokens ----
  huff[0] = br.read(4);
  huff[1] = br.read(4);
  int zzi = 1;
  for (int hgi = 1; hgi < 5; hgi++) {
    huff[0] += 16;
    huff[1] += 16;
    for (; zzi < HUFF_LIST_MAX[hgi]; zzi++) {
      for (int pli = 0; pli < 3; pli++) {
        const Codebook& book = ctx->books[huff[(pli + 1) >> 1]];
        eob_start[pli][zzi] = eobs;
        int64_t run_counts[64] = {0};
        int64_t eob_count = 0;
        int64_t ntl = ntoks_left[pli][zzi];
        int64_t ntoks = 0;
        while (ntoks + eobs < ntl) {
          ntoks += eobs;
          eob_count += eobs;
          int64_t p0 = br.pos;
          int t = book.decode(br);
          if (t < 0) return -1;
          int eb = TOKEN_EB[t] ? (int)br.read(TOKEN_EB[t]) : 0;
          toks[pli][zzi].push_back((uint8_t)t);
          ebs[pli][zzi].push_back(eb);
          if (frag_bits) tbits[pli][zzi].push_back((int32_t)(br.pos - p0));
          int64_t te; int rl, cf;
          expand_token(t, eb, &te, &rl, &cf);
          eobs = te;
          if (eobs == 0) {
            run_counts[rl]++;
            ntoks++;
          }
        }
        eob_count += ntl - ntoks;
        eobs -= ntl - ntoks;
        run_counts[63] += eob_count;
        int64_t acc = 0;
        for (int r = 63; r >= 0; r--) {
          acc += run_counts[r];
          if (zzi + r < 64) ntoks_left[pli][zzi + r] -= acc;
        }
      }
    }
  }

  // ---- Replay per fragment (decode.c:1531-1586) ----
  frag_base = 0;
  for (int pli = 0; pli < 3; pli++) {
    size_t ti[64] = {0};
    int64_t eob_runs[64];
    for (int z = 0; z < 64; z++) eob_runs[z] = eob_start[pli][z];
    for (int64_t f = 0; f < ncoded[pli]; f++) {
      int16_t* row = qcoeffs + (frag_base + f) * 64;
      int z = 0;
      int last = 0;
      while (z < 64) {
        last = z;
        if (eob_runs[z]) {
          eob_runs[z]--;
          break;
        }
        // A phase-1/phase-2 accounting divergence on an adversarial
        // packet must map to TH_EBADPACKET, not an out-of-bounds read
        // (the Python twin raises IndexError here).
        if (ti[z] >= toks[pli][z].size()) return -1;
        int t = toks[pli][z][ti[z]];
        int eb = ebs[pli][z][ti[z]];
        if (frag_bits) frag_bits[frag_base + f] += tbits[pli][z][ti[z]];
        ti[z]++;
        int64_t te; int rl, cf;
        expand_token(t, eb, &te, &rl, &cf);
        eob_runs[z] = te;
        z += rl;
        if (z < 64) row[z] = (int16_t)cf;
        if (te == 0) z++;
      }
      last_zzi[frag_base + f] = last;
    }
    frag_base += ncoded[pli];
  }
  return br.pos;
}

}  // extern "C"

// ===================================================================
// Token packer: tokenize the coded blocks and pack the residual section.
extern "C" {

// ------------------------------------------------------------------ encode
namespace {

struct EncStreams {
  std::vector<uint8_t> toks[3][64];
  std::vector<int32_t> ebs[3][64];
  int64_t eob_run[3][64];
  int64_t offs[3][64];
};

const uint8_t EOB_TOKEN_TAB[31] = {0, 1, 2, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
                                   5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5};
const uint8_t EOB_EB_TAB[31] = {0, 0, 0, 0, 1, 2, 3, 0, 1, 2, 3, 4, 5, 6, 7,
                                0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

inline void make_eob(int64_t run, int* tok, int* eb) {
  if (run < 32) {
    *tok = EOB_TOKEN_TAB[run - 1];
    *eb = EOB_EB_TAB[run - 1];
  } else {
    *tok = 6;
    *eb = (int)run;
  }
}

inline int64_t decode_eob(int tok, int eb) {
  return ((0x20820C41u >> (tok * 5)) & 0x1F) + eb;
}

inline void value_token(int v, int* tok, int* eb) {
  int a = v < 0 ? -v : v;
  int neg = v < 0;
  if (a == 1) { *tok = neg ? 10 : 9; *eb = 0; }
  else if (a == 2) { *tok = neg ? 12 : 11; *eb = 0; }
  else if (a <= 6) { *tok = 13 + a - 3; *eb = neg; }
  else if (a <= 8) { *tok = 17; *eb = (neg << 1) | (a - 7); }
  else if (a <= 12) { *tok = 18; *eb = (neg << 2) | (a - 9); }
  else if (a <= 20) { *tok = 19; *eb = (neg << 3) | (a - 13); }
  else if (a <= 36) { *tok = 20; *eb = (neg << 4) | (a - 21); }
  else if (a <= 68) { *tok = 21; *eb = (neg << 5) | (a - 37); }
  else { *tok = 22; *eb = (neg << 9) | (a - 69); }
}

inline bool combo_token(int nz, int v, int* tok, int* eb) {
  int a = v < 0 ? -v : v;
  int neg = v < 0;
  if (a == 1 && nz >= 1 && nz <= 17) {
    if (nz <= 5) { *tok = 23 + nz - 1; *eb = neg; }
    else if (nz <= 9) { *tok = 28; *eb = (neg << 2) | (nz - 6); }
    else { *tok = 29; *eb = (neg << 3) | (nz - 10); }
    return true;
  }
  if (a >= 2 && a <= 3 && nz >= 1 && nz <= 3) {
    if (nz == 1) { *tok = 30; *eb = (neg << 1) | (a - 2); }
    else { *tok = 31; *eb = (neg << 2) | ((a - 2) << 1) | (nz - 2); }
    return true;
  }
  return false;
}

void log_token(EncStreams& es, int pli, int zzi, int tok, int eb) {
  if (es.eob_run[pli][zzi] > 0) {
    int t, e;
    make_eob(es.eob_run[pli][zzi], &t, &e);
    es.toks[pli][zzi].push_back((uint8_t)t);
    es.ebs[pli][zzi].push_back(e);
    es.eob_run[pli][zzi] = 0;
  }
  es.toks[pli][zzi].push_back((uint8_t)tok);
  es.ebs[pli][zzi].push_back(eb);
}

}  // namespace

static int64_t finish_and_pack(EncStreams& es, const int32_t* huff_codes,
                               const uint8_t* prefix, int64_t prefix_bits,
                               uint8_t* out, int64_t cap,
                               int32_t* chosen_out);

// Tokenize all coded blocks and pack the residual-token section.
//
// Inputs:
//   vecs: [total, 64] int16 zig-zag coefficients with the DC *residual* at
//     index 0, in coded order; ncoded[3] per-plane counts.
//   huff_codes: [80][32][2] int32 (pattern, nbits).
//   prefix / prefix_bits: already-packed packet prefix.
// Output: out (caller-allocated, cap bytes); returns byte length or -1.
int64_t th_encode_frame_tokens(
    const int16_t* vecs, const int64_t* ncoded, const int32_t* huff_codes,
    const uint8_t* prefix, int64_t prefix_bits, uint8_t* out, int64_t cap) {
  EncStreams es;
  memset(es.eob_run, 0, sizeof(es.eob_run));
  memset(es.offs, 0, sizeof(es.offs));

  int64_t idx = 0;
  for (int pli = 0; pli < 3; pli++) {
    for (int64_t f = 0; f < ncoded[pli]; f++, idx++) {
      const int16_t* vec = vecs + idx * 64;
      int zzi = 0;
      for (int p = 0; p < 64; p++) {
        if (!vec[p]) continue;
        int v = vec[p];
        int nz = p - zzi;
        int tok, eb;
        if (nz == 0) {
          value_token(v, &tok, &eb);
          log_token(es, pli, zzi, tok, eb);
        } else if (combo_token(nz, v, &tok, &eb)) {
          log_token(es, pli, zzi, tok, eb);
        } else {
          // Pure zero run consuming nz positions, then the value.
          tok = nz <= 8 ? 7 : 8;
          log_token(es, pli, zzi, tok, nz - 1);
          value_token(v, &tok, &eb);
          log_token(es, pli, p, tok, eb);
        }
        zzi = p + 1;
      }
      if (zzi < 64) {
        int64_t run = es.eob_run[pli][zzi] + 1;
        if (run >= 4095) {
          es.toks[pli][zzi].push_back(6);
          es.ebs[pli][zzi].push_back((int)run);
          run = 0;
        }
        es.eob_run[pli][zzi] = run;
      }
    }
  }
  return finish_and_pack(es, huff_codes, prefix, prefix_bits, out, cap, nullptr);
}

static int64_t finish_and_pack(EncStreams& es, const int32_t* huff_codes,
                               const uint8_t* prefix, int64_t prefix_bits,
                               uint8_t* out, int64_t cap,
                               int32_t* chosen_out) {
  // Flush trailing runs.
  for (int pli = 0; pli < 3; pli++)
    for (int z = 0; z < 64; z++)
      if (es.eob_run[pli][z] > 0) {
        int t, e;
        make_eob(es.eob_run[pli][z], &t, &e);
        es.toks[pli][z].push_back((uint8_t)t);
        es.ebs[pli][z].push_back(e);
        es.eob_run[pli][z] = 0;
      }
  // Cross-stream EOB merge (tokenize.c:1319-1366).
  for (int z = 0; z < 64; z++) {
    for (int pli = 0; pli < 3; pli++) {
      if ((int64_t)es.toks[pli][z].size() <= es.offs[pli][z]) continue;
      int64_t first = es.offs[pli][z];
      int tok2 = es.toks[pli][z][first];
      if (tok2 > 6) continue;
      int zj = z, pj = pli;
      int64_t ti = -1;
      bool found = false;
      while (!found) {
        pj--;
        if (pj < 0) {
          zj--;
          if (zj < 0) break;
          pj = 2;
        }
        ti = (int64_t)es.toks[pj][zj].size() - 1;
        if (ti >= es.offs[pj][zj]) found = true;
      }
      if (!found) continue;
      int tok1 = es.toks[pj][zj][ti];
      if (tok1 > 6) continue;
      int64_t run = decode_eob(tok1, es.ebs[pj][zj][ti]) +
                    decode_eob(tok2, es.ebs[pli][z][first]);
      if (run >= 4096) continue;
      int t, e;
      make_eob(run, &t, &e);
      es.toks[pj][zj][ti] = (uint8_t)t;
      es.ebs[pj][zj][ti] = e;
      es.offs[pli][z]++;
    }
  }

  // Table selection by exact bit counting (encode.c:816-863).
  auto group_counts = [&](int z0, int z1, int64_t cy[32], int64_t cc[32]) {
    memset(cy, 0, 32 * sizeof(int64_t));
    memset(cc, 0, 32 * sizeof(int64_t));
    for (int z = z0; z < z1; z++) {
      for (size_t t = es.offs[0][z]; t < es.toks[0][z].size(); t++)
        cy[es.toks[0][z][t]]++;
      for (int pli = 1; pli < 3; pli++)
        for (size_t t = es.offs[pli][z]; t < es.toks[pli][z].size(); t++)
          cc[es.toks[pli][z][t]]++;
    }
  };
  auto select = [&](const int64_t counts[32], int hgi) {
    int best = 0;
    int64_t best_bits = -1;
    for (int h = 0; h < 16; h++) {
      int64_t bits = 0;
      for (int t = 0; t < 32; t++)
        bits += counts[t] * huff_codes[((hgi * 16 + h) * 32 + t) * 2 + 1];
      if (best_bits < 0 || bits < best_bits) { best_bits = bits; best = h; }
    }
    return best;
  };

  BitWriter bw;
  // Copy the prefix.
  for (int64_t i = 0; i < prefix_bits; i++)
    bw.write((prefix[i >> 3] >> (7 - (i & 7))) & 1, 1);

  auto emit_group = [&](int z0, int z1, int hy, int hc) {
    for (int z = z0; z < z1; z++) {
      for (int pli = 0; pli < 3; pli++) {
        int h = pli == 0 ? hy : hc;
        for (size_t t = es.offs[pli][z]; t < es.toks[pli][z].size(); t++) {
          int tok = es.toks[pli][z][t];
          const int32_t* c = huff_codes + (h * 32 + tok) * 2;
          bw.write((uint32_t)c[0], c[1]);
          if (TOKEN_EB[tok]) bw.write((uint32_t)es.ebs[pli][z][t], TOKEN_EB[tok]);
        }
      }
    }
  };

  int64_t cy[32], cc[32];
  group_counts(0, 1, cy, cc);
  int hy = select(cy, 0), hc = select(cc, 0);
  if (chosen_out) { chosen_out[0] = hy; chosen_out[1] = hc; }
  bw.write(hy, 4);
  bw.write(hc, 4);
  emit_group(0, 1, hy, hc);
  int64_t bits_y[16] = {0}, bits_c[16] = {0};
  for (int hgi = 1; hgi < 5; hgi++) {
    group_counts(HUFF_LIST_MAX[hgi - 1], HUFF_LIST_MAX[hgi], cy, cc);
    for (int h = 0; h < 16; h++)
      for (int t = 0; t < 32; t++) {
        bits_y[h] += cy[t] * huff_codes[((hgi * 16 + h) * 32 + t) * 2 + 1];
        bits_c[h] += cc[t] * huff_codes[((hgi * 16 + h) * 32 + t) * 2 + 1];
      }
  }
  hy = 0; hc = 0;
  for (int h = 1; h < 16; h++) {
    if (bits_y[h] < bits_y[hy]) hy = h;
    if (bits_c[h] < bits_c[hc]) hc = h;
  }
  if (chosen_out) { chosen_out[2] = hy; chosen_out[3] = hc; }
  bw.write(hy, 4);
  bw.write(hc, 4);
  for (int hgi = 1; hgi < 5; hgi++)
    emit_group(HUFF_LIST_MAX[hgi - 1], HUFF_LIST_MAX[hgi], hgi * 16 + hy,
               hgi * 16 + hc);

  bw.flush();
  if ((int64_t)bw.buf.size() > cap) return -1;
  memcpy(out, bw.buf.data(), bw.buf.size());
  return (int64_t)bw.buf.size();
}

}  // extern "C"

// ===================================================================
// DC prediction (16-case predictor shared by decode.c:1392-1500 and
// tokenize.c:977-1074).
extern "C" {

static inline int cdiv(int a, int b) {
  int q = (a < 0 ? -a : a) / b;
  return a < 0 ? -q : q;
}
static inline int wrap16(int v) { return (int16_t)v; }

// mode=0: decode (dc += pred); mode=1: encode (out = dc - pred, dc kept).
// coded: [nv*nh] uint8; refi: [nv*nh] int32; dc: [nv*nh] int32 (in/out);
// out: [nv*nh] int32 (encode residuals; may be null for decode);
// pred_last: [3] int32 running state (updated).
void th_dc_predict_plane(int mode, int nv, int nh, const uint8_t* coded,
                         const int32_t* refi, int32_t* dc, int32_t* out,
                         int32_t* pred_last) {
  for (int fy = 0; fy < nv; fy++) {
    for (int fx = 0; fx < nh; fx++) {
      int i = fy * nh + fx;
      if (!coded[i]) continue;
      int r = refi[i];
      int pred;
      if (fy == 0) {
        pred = pred_last[r];
      } else {
        int l_ref = (fx > 0 && coded[i - 1]) ? refi[i - 1] : -1;
        int ul_ref = (fx > 0 && coded[i - nh - 1]) ? refi[i - nh - 1] : -1;
        int u_ref = coded[i - nh] ? refi[i - nh] : -1;
        int ur_ref =
            (fx + 1 < nh && coded[i - nh + 1]) ? refi[i - nh + 1] : -1;
        int cs = (l_ref == r) | ((ul_ref == r) << 1) | ((u_ref == r) << 2) |
                 ((ur_ref == r) << 3);
        switch (cs) {
          case 1:
          case 3: pred = dc[i - 1]; break;
          case 2: pred = dc[i - nh - 1]; break;
          case 4:
          case 6:
          case 12: pred = dc[i - nh]; break;
          case 5: pred = cdiv(dc[i - 1] + dc[i - nh], 2); break;
          case 8: pred = dc[i - nh + 1]; break;
          case 9:
          case 11:
          case 13: pred = cdiv(75 * dc[i - 1] + 53 * dc[i - nh + 1], 128); break;
          case 10: pred = cdiv(dc[i - nh - 1] + dc[i - nh + 1], 2); break;
          case 14:
            pred = cdiv(3 * (dc[i - nh - 1] + dc[i - nh + 1]) + 10 * dc[i - nh],
                        16);
            break;
          case 7:
          case 15: {
            int p0 = dc[i - 1], p1 = dc[i - nh - 1], p2 = dc[i - nh];
            pred = cdiv(29 * (p0 + p2) - 26 * p1, 32);
            if (abs(pred - p2) > 128) pred = p2;
            else if (abs(pred - p0) > 128) pred = p0;
            else if (abs(pred - p1) > 128) pred = p1;
            break;
          }
          default: pred = pred_last[r]; break;
        }
      }
      if (mode == 0) {
        int v = wrap16(dc[i] + pred);
        dc[i] = v;
        pred_last[r] = v;
      } else {
        out[i] = wrap16(dc[i] - pred);
        pred_last[r] = dc[i];
      }
    }
  }
}

}  // extern "C"

// ===================================================================
// Frame side-info parser: frame header, coded-block flags, MB modes, MVs,
// and block-qi RLE (decode.c:442-981), producing the per-fragment arrays
// the reconstruction consumes.
extern "C" {

namespace {

inline int sb_run_decode(BitReader& br) {
  // 0 | 10x | 110x | 1110xx | 11110xxx | 111110xxxx | 111111x*12
  if (!br.read(1)) return 1;
  if (!br.read(1)) return 2 + br.read(1);
  if (!br.read(1)) return 4 + br.read(1);
  if (!br.read(1)) return 6 + br.read(2);
  if (!br.read(1)) return 10 + br.read(3);
  if (!br.read(1)) return 18 + br.read(4);
  return 34 + br.read(12);
}

inline int block_run_decode(BitReader& br) {
  // 0x | 10x | 110x | 1110xx | 11110xx | 11111xxxx
  if (!br.read(1)) return 1 + br.read(1);
  if (!br.read(1)) return 3 + br.read(1);
  if (!br.read(1)) return 5 + br.read(1);
  if (!br.read(1)) return 7 + br.read(2);
  if (!br.read(1)) return 11 + br.read(2);
  return 15 + br.read(4);
}

inline int mode_vlc_decode(BitReader& br) {
  int n = 0;
  while (n < 6 && br.read(1)) n++;
  if (n < 6) return n;
  return 6 + br.read(1);
}

// MV component VLC (decode.c:743-773).
inline int mv_vlc_decode(BitReader& br) {
  uint32_t p3 = br.read(3);
  switch (p3) {
    case 0: return 0;
    case 1: return 1;
    case 2: return -1;
    case 3: {  // '011' + 1 bit: +-2
      return br.read(1) ? -2 : 2;
    }
    case 4: {  // '100' + 1 bit: +-3
      return br.read(1) ? -3 : 3;
    }
  }
  // p3 in 5..7: read 2 more bits to complete a 5-bit prefix 20..31.
  uint32_t p5 = (p3 << 2) | br.read(2);
  if (p5 < 24) {  // 20..23: +-(4 + (p5-20)), 1 more bit for sign
    int mag = 4 + (p5 - 20);
    return br.read(1) ? -mag : mag;
  }
  if (p5 < 28) {  // 24..27: 2-bit suffix, values 8..15
    int base = 8 + (p5 - 24) * 2;
    uint32_t s = br.read(2);
    int mag = base + (s >> 1);
    return (s & 1) ? -mag : mag;
  }
  // 28..31: 3-bit suffix, values 16..31
  int base = 16 + (p5 - 28) * 4;
  uint32_t s = br.read(3);
  int mag = base + (s >> 1);
  return (s & 1) ? -mag : mag;
}

inline int mv_clc_decode(BitReader& br) {
  uint32_t v = br.read(6);
  int mag = v >> 1;
  return (v & 1) ? -mag : mag;
}

const int8_t MODE_ALPHABETS_C[7][8] = {
    {3, 4, 2, 0, 1, 5, 6, 7}, {3, 4, 0, 2, 1, 5, 6, 7},
    {3, 2, 4, 0, 1, 5, 6, 7}, {3, 2, 0, 4, 1, 5, 6, 7},
    {0, 3, 4, 2, 1, 5, 6, 7}, {0, 5, 3, 4, 2, 1, 6, 7},
    {0, 1, 2, 3, 4, 5, 6, 7}};

const int MB_MAP_IDXS_C[4][12] = {
    {0, 1, 2, 3, 4, 8, -1, -1, -1, -1, -1, -1},
    {0, 1, 2, 3, 4, 5, 8, 9, -1, -1, -1, -1},
    {0, 1, 2, 3, 4, 6, 8, 10, -1, -1, -1, -1},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11}};
const int MB_MAP_NIDXS_C[4] = {6, 8, 8, 12};

const int FRAME_FOR_MODE_C[8] = {1, 2, 1, 1, 1, 0, 0, 1};

inline int div_round_pow2(int x, int shift, int rval) {
  return (x + (x < 0 ? -1 : 0) + rval) >> shift;
}

}  // namespace

// Returns the bit position after the side info, or -1 on error.
// scan_*: canonical SB scan arrays; nsbs0 = luma plane SB count.
// Outputs: frame_type, qis[3], nqis, coded[nfrags], refi, mode,
// mv[nfrags*2] (dx, dy), qii[nfrags].
int64_t th_parse_frame_sideinfo(
    const uint8_t* packet, int64_t len, int64_t nfrags, int32_t nsbs,
    int32_t nmbs, int32_t pixel_fmt, const int32_t* scan_fragis,
    const int32_t* scan_sbi, const int32_t* scan_quadi, int64_t nscan,
    int32_t nsbs0, const int32_t* mb_maps, const uint8_t* mb_valid,
    int32_t* frame_type, int32_t* qis, int32_t* nqis, uint8_t* coded,
    int32_t* refi, int32_t* mode, int32_t* mv, int32_t* qii) {
  BitReader br;
  br.init(packet, len);
  if (br.read(1) != 0) return -1;
  *frame_type = br.read(1);
  *nqis = 1;
  qis[0] = br.read(6);
  if (br.read(1)) {
    qis[1] = br.read(6);
    *nqis = 2;
    if (br.read(1)) {
      qis[2] = br.read(6);
      *nqis = 3;
    }
  }
  memset(coded, 0, nfrags);
  for (int64_t i = 0; i < nfrags; i++) {
    refi[i] = 3;  // FRAME_NONE
    mode[i] = 0;
    mv[2 * i] = mv[2 * i + 1] = 0;
    qii[i] = 0;
  }
  std::vector<uint8_t> mb_luma_coded(nmbs, 0);
  if (*frame_type == 0) {
    // INTRA: 3 spare bits, all fragments coded.
    if (br.read(3) != 0) return -1;
    for (int64_t i = 0; i < nscan; i++) {
      int32_t f = scan_fragis[i];
      coded[f] = 1;
      refi[f] = 2;  // SELF
      mode[f] = 1;  // INTRA
    }
  } else {
    // Coded-block flags (decode.c:523-671).
    std::vector<uint8_t> sb_partial(nsbs, 0), sb_full(nsbs, 0);
    int flag = br.read(1);
    int npartial = 0;
    int32_t sbi = 0;
    while (sbi < nsbs) {
      int run = sb_run_decode(br);
      int full_run = run >= 4129;
      while (run > 0 && sbi < nsbs) {
        sb_partial[sbi++] = (uint8_t)flag;
        npartial += flag;
        run--;
      }
      if (full_run && sbi < nsbs) flag = br.read(1);
      else flag = !flag;
    }
    if (npartial < nsbs) {
      sbi = 0;
      while (sb_partial[sbi]) sbi++;
      flag = br.read(1);
      while (sbi < nsbs) {
        int run = sb_run_decode(br);
        int full_run = run >= 4129;
        while (sbi < nsbs) {
          if (sb_partial[sbi]) { sbi++; continue; }
          if (run <= 0) break;
          sb_full[sbi++] = (uint8_t)flag;
          run--;
        }
        if (full_run && sbi < nsbs) flag = br.read(1);
        else flag = !flag;
      }
    }
    flag = npartial > 0 ? !br.read(1) : 0;
    int run = 0;
    for (int64_t i = 0; i < nscan; i++) {
      int32_t f = scan_fragis[i];
      int32_t sb = scan_sbi[i];
      int c;
      if (sb_full[sb]) c = 1;
      else if (!sb_partial[sb]) c = 0;
      else {
        if (run <= 0) {
          run = block_run_decode(br);
          flag = !flag;
        }
        run--;
        c = flag;
      }
      coded[f] = (uint8_t)c;
      if (c && sb < nsbs0) mb_luma_coded[(sb << 2) | scan_quadi[i]] = 1;
    }
    // MB modes (decode.c:702-739).
    int scheme = br.read(3);
    int8_t alphabet[8];
    if (scheme == 0) {
      for (int i = 0; i < 8; i++) alphabet[i] = 0;
      for (int mi = 0; mi < 8; mi++)
        alphabet[br.read(3)] = MODE_ALPHABETS_C[6][mi];
    } else {
      memcpy(alphabet, MODE_ALPHABETS_C[scheme - 1], 8);
    }
    std::vector<int8_t> mb_modes(nmbs, 0);
    for (int32_t mbi = 0; mbi < nmbs; mbi++) {
      if (!mb_valid[mbi]) { mb_modes[mbi] = -1; continue; }
      if (mb_luma_coded[mbi]) {
        int tok = scheme == 7 ? (int)br.read(3) : mode_vlc_decode(br);
        mb_modes[mbi] = alphabet[tok];
      }
    }
    // MVs + per-fragment fill (decode.c:806-900).
    int use_clc = br.read(1);
    auto read_comp = [&]() {
      return use_clc ? mv_clc_decode(br) : mv_vlc_decode(br);
    };
    const int* map_idxs = MB_MAP_IDXS_C[pixel_fmt];
    int map_nidxs = MB_MAP_NIDXS_C[pixel_fmt];
    int last_x = 0, last_y = 0, prior_x = 0, prior_y = 0;
    for (int32_t mbi = 0; mbi < nmbs; mbi++) {
      int m = mb_modes[mbi];
      if (m == -1) continue;
      const int32_t* mm = mb_maps + (int64_t)mbi * 12;
      if (m == 7) {  // INTER_MV_FOUR
        int lbx[4] = {0, 0, 0, 0}, lby[4] = {0, 0, 0, 0};
        prior_x = last_x;
        prior_y = last_y;
        for (int bi = 0; bi < 4; bi++) {
          int32_t f = mm[bi];
          if (f >= 0 && coded[f]) {
            int dx = read_comp(), dy = read_comp();
            last_x = lbx[bi] = dx;
            last_y = lby[bi] = dy;
            refi[f] = 1;
            mode[f] = 7;
            mv[2 * f] = dx;
            mv[2 * f + 1] = dy;
          }
        }
        int cbx[4] = {0, 0, 0, 0}, cby[4] = {0, 0, 0, 0};
        if (pixel_fmt == 0) {
          cbx[0] = div_round_pow2(lbx[0] + lbx[1] + lbx[2] + lbx[3], 2, 2);
          cby[0] = div_round_pow2(lby[0] + lby[1] + lby[2] + lby[3], 2, 2);
        } else if (pixel_fmt == 2) {
          cbx[0] = div_round_pow2(lbx[0] + lbx[1], 1, 1);
          cby[0] = div_round_pow2(lby[0] + lby[1], 1, 1);
          cbx[2] = div_round_pow2(lbx[2] + lbx[3], 1, 1);
          cby[2] = div_round_pow2(lby[2] + lby[3], 1, 1);
        } else if (pixel_fmt == 1) {
          cbx[0] = div_round_pow2(lbx[0] + lbx[2], 1, 1);
          cby[0] = div_round_pow2(lby[0] + lby[2], 1, 1);
          cbx[1] = div_round_pow2(lbx[1] + lbx[3], 1, 1);
          cby[1] = div_round_pow2(lby[1] + lby[3], 1, 1);
        } else {
          for (int k = 0; k < 4; k++) { cbx[k] = lbx[k]; cby[k] = lby[k]; }
        }
        for (int mi = 4; mi < map_nidxs; mi++) {
          int mapi = map_idxs[mi];
          int bi = mapi & 3;
          int32_t f = mm[(mapi >> 2) * 4 + bi];
          if (f >= 0 && coded[f]) {
            refi[f] = 1;
            mode[f] = 7;
            mv[2 * f] = cbx[bi];
            mv[2 * f + 1] = cby[bi];
          }
        }
      } else {
        int mvx = 0, mvy = 0;
        switch (m) {
          case 2:  // INTER_MV
            prior_x = last_x; prior_y = last_y;
            mvx = read_comp(); mvy = read_comp();
            last_x = mvx; last_y = mvy;
            break;
          case 3:  // LAST
            mvx = last_x; mvy = last_y;
            break;
          case 4: {  // LAST2
            mvx = prior_x; mvy = prior_y;
            prior_x = last_x; prior_y = last_y;
            last_x = mvx; last_y = mvy;
            break;
          }
          case 6:  // GOLDEN_MV
            mvx = read_comp(); mvy = read_comp();
            break;
          default:
            break;
        }
        int rf = FRAME_FOR_MODE_C[m];
        for (int mi = 0; mi < map_nidxs; mi++) {
          int mapi = map_idxs[mi];
          int32_t f = mm[(mapi >> 2) * 4 + (mapi & 3)];
          if (f >= 0 && coded[f]) {
            refi[f] = rf;
            mode[f] = m;
            mv[2 * f] = mvx;
            mv[2 * f + 1] = mvy;
          }
        }
      }
    }
  }
  // Coded fragments not covered by a coded-luma MB (e.g. chroma blocks of
  // a fully-skipped-luma MB) default to INTER_NOMV from PREV -- the
  // reference's zero-initialized frag state (decode.c:736-804 never
  // touches them).
  if (*frame_type != 0) {
    for (int64_t i = 0; i < nscan; i++) {
      int32_t f = scan_fragis[i];
      if (coded[f] && refi[f] == 3) {
        refi[f] = 1;  // FRAME_PREV
        mode[f] = 0;  // MODE_INTER_NOMV
      }
    }
  }
  // Block qi RLE (decode.c:902-981) over coded fragments in scan order.
  if (*nqis > 1) {
    std::vector<int64_t> order;
    order.reserve(nscan);
    for (int64_t i = 0; i < nscan; i++)
      if (coded[scan_fragis[i]]) order.push_back(scan_fragis[i]);
    int64_t n = (int64_t)order.size();
    if (n > 0) {
      std::vector<int8_t> q(n, 0);
      int flag = br.read(1);
      int64_t nqi1 = 0, i = 0;
      while (i < n) {
        int run = sb_run_decode(br);
        int full_run = run >= 4129;
        while (run > 0 && i < n) {
          q[i++] = (int8_t)flag;
          nqi1 += flag;
          run--;
        }
        if (full_run && i < n) flag = br.read(1);
        else flag = !flag;
      }
      if (*nqis == 3 && nqi1 > 0) {
        i = 0;
        while (q[i] == 0) i++;
        flag = br.read(1);
        while (i < n) {
          int run = sb_run_decode(br);
          int full_run = run >= 4129;
          while (i < n) {
            if (q[i] == 0) { i++; continue; }
            if (run <= 0) break;
            q[i++] += (int8_t)flag;
            run--;
          }
          if (full_run && i < n) flag = br.read(1);
          else flag = !flag;
        }
      }
      for (int64_t k = 0; k < n; k++) qii[order[k]] = q[k];
    }
  }
  return br.pos;
}

}  // extern "C"

// ===================================================================
// Coded-block flags (encode.c:487-589).
extern "C" {

namespace {

const int SB_RUN_VAL_MIN[8] = {1, 2, 4, 6, 10, 18, 34, 4130};
const int SB_RUN_CODE_PREFIX[7] = {0, 4, 0xC, 0x38, 0xF0, 0x3E0, 0x3F000};
const int SB_RUN_CODE_NBITS[7] = {1, 3, 4, 6, 8, 10, 18};
const int BLK_RUN_NBITS[30] = {2, 2, 3, 3, 4, 4, 6, 6, 6, 6, 7, 7, 7, 7,
                               9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9,
                               9, 9};
const int BLK_RUN_PAT[30] = {0x000, 0x001, 0x004, 0x005, 0x00C, 0x00D,
                             0x038, 0x039, 0x03A, 0x03B, 0x078, 0x079,
                             0x07A, 0x07B, 0x1F0, 0x1F1, 0x1F2, 0x1F3,
                             0x1F4, 0x1F5, 0x1F6, 0x1F7, 0x1F8, 0x1F9,
                             0x1FA, 0x1FB, 0x1FC, 0x1FD, 0x1FE, 0x1FF};

void sb_run_pack_c(BitWriter& bw, int64_t run, int flag, bool done) {
  if (run >= 4129) {
    while (run >= 4129) {
      bw.write(0x3FFFF, 18);
      run -= 4129;
      if (run > 0)
        bw.write(flag, 1);
      else if (!done)
        bw.write(flag ? 0 : 1, 1);
    }
    if (run <= 0) return;
  }
  int i = 0;
  while (run >= SB_RUN_VAL_MIN[i + 1]) i++;
  bw.write((uint32_t)(SB_RUN_CODE_PREFIX[i] + run - SB_RUN_VAL_MIN[i]),
           SB_RUN_CODE_NBITS[i]);
}

}  // namespace

// Packs the coded-block flag section into `out`; returns the bit count
// (or -1 on overflow). sb_partial_out receives the per-SB partial flags.
int64_t th_coded_flags_pack(const uint8_t* coded, const int32_t* scan_fragis,
                            const int32_t* scan_sbi, int64_t nscan,
                            int64_t nsbs, uint8_t* out, int64_t cap,
                            uint8_t* sb_partial_out) {
  std::vector<uint8_t> sb_any(nsbs, 0), sb_all(nsbs, 1), has(nsbs, 0);
  for (int64_t i = 0; i < nscan; i++) {
    uint8_t c = coded[scan_fragis[i]];
    int sbi = scan_sbi[i];
    sb_any[sbi] |= c;
    sb_all[sbi] &= c;
    has[sbi] = 1;
  }
  std::vector<uint8_t> sb_partial(nsbs), sb_full(nsbs);
  int64_t npartial = 0;
  for (int64_t s = 0; s < nsbs; s++) {
    sb_partial[s] = sb_any[s] && !(sb_all[s] && has[s]);
    sb_full[s] = sb_all[s] && has[s] && !sb_partial[s];
    npartial += sb_partial[s];
    sb_partial_out[s] = sb_partial[s];
  }
  BitWriter bw;
  int flag = sb_partial[0];
  bw.write(flag, 1);
  int64_t sbi = 0;
  while (sbi < nsbs) {
    int64_t run = 0;
    while (sbi < nsbs && sb_partial[sbi] == flag) { run++; sbi++; }
    sb_run_pack_c(bw, run, flag, sbi >= nsbs);
    flag = 1 - flag;
  }
  if (npartial < nsbs) {
    std::vector<int32_t> order;
    order.reserve(nsbs - npartial);
    for (int64_t s = 0; s < nsbs; s++)
      if (!sb_partial[s]) order.push_back((int32_t)s);
    flag = sb_full[order[0]];
    bw.write(flag, 1);
    size_t i = 0;
    while (i < order.size()) {
      int64_t run = 0;
      while (i < order.size() && sb_full[order[i]] == flag) { run++; i++; }
      sb_run_pack_c(bw, run, flag, i >= order.size());
      flag = 1 - flag;
    }
  }
  if (npartial > 0) {
    std::vector<uint8_t> flags;
    flags.reserve(nscan);
    for (int64_t i = 0; i < nscan; i++)
      if (sb_partial[scan_sbi[i]]) flags.push_back(coded[scan_fragis[i]]);
    flag = flags[0];
    bw.write(flag, 1);
    size_t i = 0;
    while (i < flags.size()) {
      int run = 0;
      while (i < flags.size() && flags[i] == flag) { run++; i++; }
      // A partial SB holds <= 15 same-flag blocks and a run spans at
      // most 2 partial SBs (encode.c:425-452).
      if (run > 30) return -1;
      bw.write((uint32_t)BLK_RUN_PAT[run - 1], BLK_RUN_NBITS[run - 1]);
      flag = 1 - flag;
    }
  }
  int64_t bits = (int64_t)bw.buf.size() * 8 + bw.curbits;
  bw.flush();
  if ((int64_t)bw.buf.size() > cap) return -1;
  memcpy(out, bw.buf.data(), bw.buf.size());
  return bits;
}

}  // extern "C"

// ===================================================================
// MB-mode scheme selection + emission (encode.c:591-621): histogram the
// coded modes, pick the cheapest of 8 coding schemes (custom ranking /
// 6 fixed alphabets / 3-bit CLC), and emit. Returns bit count or -1.
extern "C" int64_t th_mb_modes_pack(const int32_t* modes, int64_t n,
                                    const int32_t* alphabets /*[6][8]*/,
                                    uint8_t* out, int64_t cap) {
  static const int VLC_BITS[8] = {1, 2, 3, 4, 5, 6, 7, 7};
  static const uint32_t VLC_CODES[8] = {0, 2, 6, 14, 30, 62, 126, 127};
  int64_t hist[8] = {0};
  for (int64_t i = 0; i < n; i++) hist[modes[i]]++;
  // Scheme 0: rank by descending frequency (stable, ties by mode index).
  int order0[8];
  for (int m = 0; m < 8; m++) order0[m] = m;
  std::stable_sort(order0, order0 + 8,
                   [&](int a, int b) { return hist[a] > hist[b]; });
  int rank0[8];
  for (int r = 0; r < 8; r++) rank0[order0[r]] = r;
  int64_t costs[8];
  costs[0] = 24;
  for (int m = 0; m < 8; m++) costs[0] += hist[m] * VLC_BITS[rank0[m]];
  for (int s = 1; s < 7; s++) {
    int rank[8];
    for (int r = 0; r < 8; r++) rank[alphabets[(s - 1) * 8 + r]] = r;
    costs[s] = 0;
    for (int m = 0; m < 8; m++) costs[s] += hist[m] * VLC_BITS[rank[m]];
  }
  costs[7] = 3 * n;
  int scheme = 0;
  for (int s = 1; s < 8; s++)
    if (costs[s] < costs[scheme]) scheme = s;
  BitWriter bw;
  bw.write((uint32_t)scheme, 3);
  int rank[8];
  if (scheme == 0) {
    for (int m = 0; m < 8; m++) bw.write((uint32_t)rank0[m], 3);
    for (int m = 0; m < 8; m++) rank[m] = rank0[m];
  } else if (scheme == 7) {
    for (int m = 0; m < 8; m++) rank[m] = m;
  } else {
    for (int r = 0; r < 8; r++) rank[alphabets[(scheme - 1) * 8 + r]] = r;
  }
  for (int64_t i = 0; i < n; i++) {
    int r = rank[modes[i]];
    if (scheme == 7)
      bw.write((uint32_t)r, 3);
    else
      bw.write(VLC_CODES[r], VLC_BITS[r]);
  }
  int64_t bits = (int64_t)bw.buf.size() * 8 + bw.curbits;
  bw.flush();
  if ((int64_t)bw.buf.size() > cap) return -1;
  memcpy(out, bw.buf.data(), bw.buf.size());
  return bits;
}

// ===================================================================
// Device-tier sequential mode decision (encode/tpu_gop.py
// _decide_frame): the LAST/LAST2-aware walk over device-precomputed
// SADs.  The walk order carries the decoder's last/prior MV state
// (decode.c:806-900) so it is inherently serial; in Python it measured
// ~33 ms per 720p frame -- the clip-batched driver's host floor.
// All costs are IEEE doubles exactly as the Python expressions
// (int SAD + double bias products); ties keep the FIRST candidate in
// the fixed evaluation order, matching Python's min().
extern "C" void th_mode_decide(
    int64_t nmb_walk, const int32_t* mb_list, const int32_t* mb_row,
    const int32_t* mb_col, const uint8_t* mb_all4,
    const int32_t* mb_birc,                     // [nmb_walk, 4, 2]
    const int32_t* mv,                          // [nv, nh, 2]
    const int32_t* sad_mv, const int32_t* sad_nomv,
    const int32_t* sad_gold, const int32_t* sad_intra,  // [nv, nh]
    const int32_t* cands,                       // [K, 2]
    const int32_t* cand_sads,                   // [K, nv, nh]
    const int32_t* gmv,                         // [nv, nh, 2]
    const int32_t* sad_gmv,                     // [nv, nh]
    const int32_t* bmv,                         // [2nv, 2nh, 2]
    const int32_t* bsad4,                       // [nv, nh] 4MV sums
    int64_t nv, int64_t nh, int64_t K, double b, double mvb,
    int32_t no_mc,
    int32_t* mb_modes, int32_t* mb_mvs, int32_t* mb_bmvs) {
  enum { NOMV = 0, INTRA = 1, MVM = 2, LAST = 3, LAST2 = 4,
         GNOMV = 5, GMV = 6, FOUR = 7 };
  int cand_tab[63 * 63];
  for (int i = 0; i < 63 * 63; i++) cand_tab[i] = -1;
  for (int64_t k = 0; k < K; k++) {
    int dx = cands[2 * k], dy = cands[2 * k + 1];
    if (dx || dy) cand_tab[(dx + 31) * 63 + (dy + 31)] = (int)k;
  }
  int lx = 0, ly = 0, px = 0, py = 0;
  for (int64_t i = 0; i < nmb_walk; i++) {
    const int64_t mbi = mb_list[i];
    const int64_t r = mb_row[i], c = mb_col[i];
    const int64_t rc = r * nh + c;
    int bx = mv[2 * rc], by = mv[2 * rc + 1];
    int gx = gmv[2 * rc], gy = gmv[2 * rc + 1];
    if (no_mc) { bx = by = gx = gy = 0; }
    double best_cost = (double)sad_nomv[rc];
    int mode = NOMV, vx = 0, vy = 0;
    auto consider = [&](double cost, int m, int x, int y) {
      if (cost < best_cost) { best_cost = cost; mode = m; vx = x; vy = y; }
    };
    consider((double)sad_intra[rc] + 350.0 * b, INTRA, 0, 0);
    consider((double)sad_gold[rc] + 80.0 * b, GNOMV, 0, 0);
    if (bx || by) consider((double)sad_mv[rc] + mvb, MVM, bx, by);
    if (gx || gy)
      consider((double)sad_gmv[rc] + mvb + 80.0 * b, GMV, gx, gy);
    if (!no_mc && mb_all4[i])
      consider((double)bsad4[rc] + 640.0 * b + 4.0 * mvb, FOUR, 0, 0);
    auto sad_at = [&](int x, int y) -> int64_t {
      if (x == bx && y == by) return sad_mv[rc];
      const int k = cand_tab[(x + 31) * 63 + (y + 31)];
      return k < 0 ? -1 : (int64_t)cand_sads[k * nv * nh + rc];
    };
    if (lx || ly) {
      const int64_t s = sad_at(lx, ly);
      if (s >= 0) consider((double)s + 16.0 * b, LAST, lx, ly);
    }
    if ((px || py) && (px != lx || py != ly)) {
      const int64_t s = sad_at(px, py);
      if (s >= 0) consider((double)s + 24.0 * b, LAST2, px, py);
    }
    mb_modes[mbi] = mode;
    switch (mode) {
      case MVM:
        mb_mvs[2 * mbi] = vx; mb_mvs[2 * mbi + 1] = vy;
        px = lx; py = ly; lx = vx; ly = vy;
        break;
      case LAST:
        mb_mvs[2 * mbi] = vx; mb_mvs[2 * mbi + 1] = vy;
        break;
      case LAST2: {
        mb_mvs[2 * mbi] = vx; mb_mvs[2 * mbi + 1] = vy;
        int tx = lx, ty = ly; lx = px; ly = py; px = tx; py = ty;
        break;
      }
      case GMV:
        mb_mvs[2 * mbi] = vx; mb_mvs[2 * mbi + 1] = vy;
        break;
      case FOUR: {
        for (int j = 0; j < 4; j++) {
          const int64_t br = mb_birc[(i * 4 + j) * 2];
          const int64_t bc = mb_birc[(i * 4 + j) * 2 + 1];
          mb_bmvs[(mbi * 4 + j) * 2] = bmv[(br * 2 * nh + bc) * 2];
          mb_bmvs[(mbi * 4 + j) * 2 + 1] = bmv[(br * 2 * nh + bc) * 2 + 1];
        }
        px = lx; py = ly;
        lx = mb_bmvs[(mbi * 4 + 3) * 2];
        ly = mb_bmvs[(mbi * 4 + 3) * 2 + 1];
        break;
      }
      default:
        break;
    }
  }
}

// ===================================================================
// The keyframe path of the host encoder (encode/encoder.py): forward DCT
// + R/D quantization, the Viterbi trellis planner and the permuted plan
// packer. Copied from theora_tpu/native/entropy.cpp.
namespace {

const int32_t C1 = 64277, C2 = 60547, C3 = 54491, C4 = 46341, C5 = 36410,
              C6 = 25080, C7 = 12785;

const int ZIGN[64] = {
  0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
  35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
  58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

}  // namespace

// Forward DCT + R/D quantization (the C++ twin of the JAX package's
// ops/fdct_np.py).
extern "C" {

namespace {

inline void fdct8_1d(const int32_t* x, int32_t* y, int xs, int ys) {
  int32_t t0 = x[0 * xs] + x[7 * xs];
  int32_t t7 = x[0 * xs] - x[7 * xs];
  int32_t t1 = x[1 * xs] + x[6 * xs];
  int32_t t6 = x[1 * xs] - x[6 * xs];
  int32_t t2 = x[2 * xs] + x[5 * xs];
  int32_t t5 = x[2 * xs] - x[5 * xs];
  int32_t t3 = x[3 * xs] + x[4 * xs];
  int32_t t4 = x[3 * xs] - x[4 * xs];
  int32_t r = t0 + t3; t3 = t0 - t3; t0 = r;
  r = t1 + t2; t2 = t1 - t2; t1 = r;
  r = t6 + t5; t5 = t6 - t5; t6 = r;
  int32_t s = (((27146 * t5 + 0xB500) >> 16) + t5 + (t5 != 0)) >> 1;
  r = t4 + s; t5 = t4 - s; t4 = r;
  s = (((27146 * t6 + 0xB500) >> 16) + t6 + (t6 != 0)) >> 1;
  r = t7 + s; t6 = t7 - s; t7 = r;
  r = ((27146 * t0 + 0x4000) >> 16) + t0 + (t0 != 0);
  s = ((27146 * t1 + 0xB500) >> 16) + t1 + (t1 != 0);
  int32_t u = (r + s) >> 1;
  int32_t v = r - u;
  y[0 * ys] = (int16_t)u;
  y[4 * ys] = (int16_t)v;
  u = ((C6 * t2 + C2 * t3 + 0x6CB7) >> 16) + (t3 != 0);
  s = ((C6 * u) >> 16) - t2;
  v = ((s * 21600 + 0x2800) >> 18) + s + (s != 0);
  y[2 * ys] = (int16_t)u;
  y[6 * ys] = (int16_t)v;
  u = ((C5 * t6 + C3 * t5 + 0x0E3D) >> 16) + (t5 != 0);
  s = t6 - ((C5 * u) >> 16);
  v = ((s * 26568 + 0x3400) >> 17) + s + (s != 0);
  y[5 * ys] = (int16_t)u;
  y[3 * ys] = (int16_t)v;
  u = ((C7 * t4 + C1 * t7 + 0x7B1B) >> 16) + (t7 != 0);
  s = ((C7 * u) >> 16) - t4;
  v = ((s * 20539 + 0x3000) >> 20) + s + (s != 0);
  y[1 * ys] = (int16_t)u;
  y[7 * ys] = (int16_t)v;
}

const double MAG_BITS[9] = {0.0, 4.5, 5.5, 6.5, 6.5, 7.5, 7.5, 8.5, 9.5};

}  // namespace

// res: [n, 64] int32 residual blocks (row-major); dq: [64] int32 zig-zag
// dequant; lam: lambda. Outputs: qz [n,64] int16 zig-zag quantized;
// err2/res2: [n] int64 (coding error and x16 pixel energy).
static void fdct_quantize_rd_range(int64_t lo, int64_t hi,
                                   const int32_t* res, const int32_t* dq,
                                   double lam, int rd, int16_t* qz,
                                   int64_t* err2, int64_t* res2,
                                   int16_t* dct_out) {
  for (int64_t i = lo; i < hi; i++) {
    const int32_t* x = res + i * 64;
    int32_t w[64], y[64];
    int64_t r2 = 0;
    for (int k = 0; k < 64; k++) {
      w[k] = x[k] << 2;
      r2 += (int64_t)x[k] * x[k];
    }
    w[0] += (w[0] != 0) + 1;
    w[1] += 1;
    w[8] -= 1;
    // Columns of w -> rows of y, then columns of y -> rows of w
    // (fdct.c:128-154): oc_fdct8 reads every 8th entry, writes 8
    // consecutive.
    for (int k = 0; k < 8; k++) fdct8_1d(w + k, y + 8 * k, 8, 1);
    for (int k = 0; k < 8; k++) fdct8_1d(y + k, w + 8 * k, 8, 1);
    int32_t dct[64];
    for (int z = 0; z < 64; z++)
      dct[z] = (int16_t)((w[ZIGN[z]] + 2) >> 2);
    if (dct_out)
      for (int z = 0; z < 64; z++) dct_out[i * 64 + z] = (int16_t)dct[z];
    // Quantize (round-to-nearest, ties away from zero).
    int16_t q[64];
    for (int z = 0; z < 64; z++) {
      int64_t d = dq[z];
      int64_t v2 = (int64_t)2 * (dct[z] < 0 ? -dct[z] : dct[z]);
      int64_t qq = v2 >= d ? (v2 + d) / (2 * d) : 0;
      q[z] = (int16_t)(dct[z] < 0 ? -qq : qq);
    }
    if (rd) {
      // Magnitude-step choice (AC only).
      for (int z = 1; z < 64; z++) {
        int a0 = q[z] < 0 ? -q[z] : q[z];
        if (!a0) continue;
        int a1 = a0 - 1;
        int64_t d = dq[z];
        int64_t av = dct[z] < 0 ? -dct[z] : dct[z];
        double e0 = (double)(a0 * d - av) * (a0 * d - av);
        double e1 = (double)(a1 * d - av) * (a1 * d - av);
        double b0 = MAG_BITS[a0 > 8 ? 8 : a0];
        double b1 = MAG_BITS[a1 > 8 ? 8 : a1];
        if (e1 + lam * b1 <= e0 + lam * b0)
          q[z] = (int16_t)(q[z] < 0 ? -a1 : a1);
      }
      // Isolated +-1 kill (2 sweeps).
      for (int sweep = 0; sweep < 2; sweep++) {
        bool any = false;
        for (int z = 1; z < 64; z++) {
          if (q[z] != 1 && q[z] != -1) continue;
          bool lz = z < 2 || q[z - 1] == 0;
          bool rz = z == 63 || q[z + 1] == 0;
          if (!(lz && rz)) continue;
          int64_t d = dq[z];
          int64_t av = dct[z] < 0 ? -dct[z] : dct[z];
          double ec = (double)(d - av) * (d - av);
          double ez = (double)av * av;
          if (ez - ec <= lam * 11.0) { q[z] = 0; any = true; }
        }
        if (!any) break;
      }
      // Tail kill (4 sweeps).
      for (int sweep = 0; sweep < 4; sweep++) {
        int last = -1;
        for (int z = 63; z >= 1; z--)
          if (q[z]) { last = z; break; }
        if (last < 1) break;
        if (q[last] != 1 && q[last] != -1) break;
        int64_t d = dq[last];
        int64_t av = dct[last] < 0 ? -dct[last] : dct[last];
        double ec = (double)(1 * d - av) * (1 * d - av);
        double ez = (double)av * av;
        if (ez - ec > lam * 14.0) break;
        q[last] = 0;
      }
    }
    int64_t e2 = 0;
    for (int z = 0; z < 64; z++) {
      int64_t d = (int64_t)dct[z] - (int64_t)q[z] * dq[z];
      e2 += d * d;
      qz[i * 64 + z] = q[z];
    }
    err2[i] = e2;
    res2[i] = r2 * 16;
  }
}

void th_fdct_quantize_rd(int64_t n, const int32_t* res, const int32_t* dq,
                         double lam, int rd, int16_t* qz, int64_t* err2,
                         int64_t* res2, int16_t* dct_out) {
  // Per-block independent: split large batches across cores (same
  // disjoint-output argument as th_trellis_plan_blocks).
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = (int)(hw ? hw : 1);
  if (nthreads > 4) nthreads = 4;
  if (n < 4096 || nthreads < 2) {
    fdct_quantize_rd_range(0, n, res, dq, lam, rd, qz, err2, res2, dct_out);
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; t++) {
    int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    ts.emplace_back(fdct_quantize_rd_range, lo, hi, res, dq, lam, rd, qz,
                    err2, res2, dct_out);
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"

// ===================================================================
// Viterbi trellis tokenizer (re-derivation of tokenize.c:457-744). Phase 1
// plans per-block token paths with exact Huffman bit costs; phase 2
// replays the plans into streams and packs them.
namespace {

const uint8_t ZZI_GROUP_T[64] = {
    0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3,
    3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4};

// Largest magnitude with a strictly cheaper value token (top of the
// next-lower token category).
inline int alt_mag(int a) {
  if (a <= 7) return a - 1;
  if (a <= 8) return 6;
  if (a <= 12) return 8;
  if (a <= 20) return 12;
  if (a <= 36) return 20;
  if (a <= 68) return 36;
  return 68;
}

// One block's plan. path rows: (stream_zzi, token, eb, qc); a token < 7
// marks the terminal EOB; a row with zzi < 0 terminates the list.
// Returns the AC bits estimate (terminal EOB excluded) and fills
// vals[64] with the chosen AC values (DC slot untouched).
static int64_t trellis_block(const int16_t* dct, const int16_t* qdct,
                             const int32_t* dq, int64_t lam, int acmin,
                             const int64_t* nbt, int16_t* path,
                             int16_t* vals) {
  auto nb = [&](int zzi, int tok) -> int64_t {
    return nbt[(int)ZZI_GROUP_T[zzi] * 32 + tok];
  };
  int zzi_max = 1;
  for (int z = 63; z >= 1; z--)
    if (qdct[z]) { zzi_max = z + 1 > 63 ? 63 : z + 1; break; }

  uint8_t nxt[64][2] = {};
  int8_t tokv[64][2] = {};
  int16_t ebv[64][2] = {};
  int64_t cost[64][2] = {};
  int64_t bitsv[64][2] = {};
  int16_t qcv[64][2] = {};
  int64_t d2_accum[64] = {};
  uint64_t zflags = 1, nzflags = 0, bflags = 0;
  int zzj = 64;
  int zzi = zzi_max;
  while (zzi > 0) {
    int qc = qdct[zzi];
    int aqc = qc < 0 ? -qc : qc;
    int64_t c = dct[zzi];
    if (aqc <= 1) {
      int64_t d2;
      if (aqc == 0) {
        while (zzi > 1 && !qdct[zzi - 1]) zzi--;
        d2 = 0;
      } else {
        d2 = c * c;
        c = c < 0 ? -c : c;
      }
      int nzeros = zzj - zzi;
      zzj &= 63;
      int64_t sum_d2 = d2 + d2_accum[zzj];
      d2_accum[zzi] = sum_d2;
      int dc_reserve = (zzi + 62) >> 6;
      int64_t best_cost = INT64_MAX, best_bits = 0;
      int best_next = 0, best_token = 0, best_eb = 0, best_qc = 0;
      bool have_best = false;
      for (;;) {
        if ((nzflags >> zzj) & 1) {
          int nx1 = nxt[zzj][1];
          int tk = nx1 & 1;
          int zzk = nx1 >> 1;
          int token = 7 + ((nzeros + 55) >> 6);
          int64_t b = nb(zzi, token);
          int64_t cst = sum_d2 - d2_accum[zzj] + lam * b + cost[zzj][1];
          if (cst <= best_cost) {
            best_next = (zzj << 1) + 1;
            best_token = token;
            best_eb = nzeros - 1;
            best_cost = cst;
            best_bits = b + bitsv[zzj][1];
            best_qc = 0;
            have_best = true;
          }
          if (nzeros < 17 + dc_reserve) {
            int val = qdct[zzj];
            int va = val < 0 ? -val : val;
            if (va <= 2) {
              int sval = val < 0 ? -1 : 1;
              int ctok, ceb;
              combo_token(nzeros, sval, &ctok, &ceb);
              int64_t e = (int64_t)dct[zzj] - (int64_t)sval * dq[zzj];
              b = nb(zzi, ctok);
              int64_t cst2 =
                  e * e + sum_d2 - d2_accum[zzj] + lam * b + cost[zzk][tk];
              if (cst2 <= best_cost) {
                best_next = nx1;
                best_token = ctok;
                best_eb = ceb;
                best_cost = cst2;
                best_bits = b + bitsv[zzk][tk];
                best_qc = sval;
                have_best = true;
              }
            }
            if (nzeros < 3 + dc_reserve && va >= 2 && va <= 4) {
              int v2 = 2 + (va > 2);
              int sval = val < 0 ? -v2 : v2;
              int ctok, ceb;
              combo_token(nzeros, sval, &ctok, &ceb);
              int64_t e = (int64_t)dct[zzj] - (int64_t)sval * dq[zzj];
              b = nb(zzi, ctok);
              int64_t cst2 =
                  e * e + sum_d2 - d2_accum[zzj] + lam * b + cost[zzk][tk];
              if (cst2 <= best_cost) {
                best_next = nx1;
                best_token = ctok;
                best_eb = ceb;
                best_cost = cst2;
                best_bits = b + bitsv[zzk][tk];
                best_qc = sval;
                have_best = true;
              }
            }
          }
          if (!((zflags >> zzj) & 1)) break;
        }
        zzj = ((nxt[zzj][0] >> 1) - (qcv[zzj][0] != 0)) & 63;
        if (zzj == 0) {
          // EOB terminal; pending-run hint is 0 at planning time.
          int t1, e1;
          make_eob(1, &t1, &e1);
          int64_t b = nb(zzi, t1);
          int64_t cst = sum_d2 + lam * b;
          if (cst <= best_cost ||
              (have_best && best_token <= 8 && zzi + best_eb == 63)) {
            best_next = 0;
            best_token = 0;
            best_eb = 0;
            best_cost = cst;
            best_bits = b;
            best_qc = 0;
          }
          break;
        }
        nzeros = zzj - zzi;
      }
      nxt[zzi][0] = (uint8_t)best_next;
      tokv[zzi][0] = (int8_t)best_token;
      ebv[zzi][0] = (int16_t)best_eb;
      cost[zzi][0] = best_cost;
      bitsv[zzi][0] = best_bits;
      qcv[zzi][0] = (int16_t)best_qc;
      zflags |= 1ull << zzi;
      if (aqc) {
        if (zzi < acmin) lam = 0;
        int64_t dqz = dq[zzi];
        int64_t e = dqz - c;
        int token = qc > 0 ? 9 : 10;
        int64_t b = nb(zzi, token);
        int zzk = (zzi + 1) & 63;
        int tk = (bflags >> zzk) & 1;
        nxt[zzi][1] = (uint8_t)((zzk << 1) + tk);
        tokv[zzi][1] = (int8_t)token;
        ebv[zzi][1] = 0;
        cost[zzi][1] = e * e + lam * b + cost[zzk][tk];
        bitsv[zzi][1] = b + bitsv[zzk][tk];
        qcv[zzi][1] = (int16_t)(qc > 0 ? 1 : -1);
        nzflags |= 1ull << zzi;
        if (cost[zzi][1] < cost[zzi][0]) bflags |= 1ull << zzi;
      }
    } else {
      if (zzi < acmin) lam = 0;
      int64_t dqz = dq[zzi];
      d2_accum[zzi] = 0;
      if (aqc > 580) {
        qc = qc > 0 ? 580 : -580;
        aqc = 580;
      }
      int64_t e = (int64_t)qc * dqz - c;
      int btok, bebt;
      value_token(qc, &btok, &bebt);
      int64_t bbits = nb(zzi, btok);
      int64_t bcost = e * e + lam * bbits;
      int bqc = qc;
      int alt = alt_mag(aqc);
      int salt = qc < 0 ? -alt : alt;
      e = (int64_t)salt * dqz - c;
      int atok, aebt;
      value_token(salt, &atok, &aebt);
      int64_t ab = nb(zzi, atok);
      int64_t acst = e * e + lam * ab;
      if (acst < bcost) {
        btok = atok;
        bebt = aebt;
        bbits = ab;
        bcost = acst;
        bqc = salt;
      }
      int zzk = (zzi + 1) & 63;
      int tk = (bflags >> zzk) & 1;
      nxt[zzi][1] = (uint8_t)((zzk << 1) + tk);
      tokv[zzi][1] = (int8_t)btok;
      ebv[zzi][1] = (int16_t)bebt;
      cost[zzi][1] = bcost + cost[zzk][tk];
      bitsv[zzi][1] = bbits + bitsv[zzk][tk];
      qcv[zzi][1] = (int16_t)bqc;
      nzflags |= 1ull << zzi;
      bflags |= 1ull << zzi;
    }
    zzj = zzi;
    zzi--;
  }

  // Walk the winning path forward.
  int ti = (bflags >> 1) & 1;
  int64_t ac_bits = bitsv[1][ti];
  int zi = 1;
  int np = 0;
  for (int z = 1; z < 64; z++) vals[z] = 0;
  while (zi) {
    int token = tokv[zi][ti];
    if (token < 7) {
      ac_bits -= bitsv[zi][ti];
      path[np * 4 + 0] = (int16_t)zi;
      path[np * 4 + 1] = 0;
      path[np * 4 + 2] = 0;
      path[np * 4 + 3] = 0;
      np++;
      break;
    }
    int nx = nxt[zi][ti];
    int qc = qcv[zi][ti];
    path[np * 4 + 0] = (int16_t)zi;
    path[np * 4 + 1] = (int16_t)token;
    path[np * 4 + 2] = ebv[zi][ti];
    path[np * 4 + 3] = (int16_t)qc;
    np++;
    if (qc) vals[((nx >> 1) - 1) & 63] = (int16_t)qc;
    zi = nx >> 1;
    ti = nx & 1;
  }
  if (np < 66) path[np * 4 + 0] = -1;
  return ac_bits;
}

// Replays a plan into the streams, weaving in the DC slot (the
// counterpart of TokenLog.emit_trellis; the reference instead rewrites
// stacks after DC prediction, tokenize.c:1076-1309).
static void emit_plan(EncStreams& es, int pli, int dc, const int16_t* path) {
  bool first_ac = true;
  if (dc != 0) {
    int t, e;
    value_token(dc, &t, &e);
    log_token(es, pli, 0, t, e);
    first_ac = false;
  }
  for (int np = 0; np < 66; np++) {
    int zzi = path[np * 4 + 0];
    if (zzi < 0) return;  // ran off the end (position 63 coded)
    int token = path[np * 4 + 1];
    int eb = path[np * 4 + 2];
    int qc = path[np * 4 + 3];
    if (token < 7) {
      int stream = first_ac ? 0 : zzi;
      int64_t run = es.eob_run[pli][stream] + 1;
      if (run >= 4095) {
        es.toks[pli][stream].push_back(6);
        es.ebs[pli][stream].push_back((int)run);
        run = 0;
      }
      es.eob_run[pli][stream] = run;
      return;
    }
    if (first_ac) {
      first_ac = false;
      if (token == 7 || token == 8) {
        int run = eb + 2;  // extend over the zero DC
        log_token(es, pli, 0, run <= 8 ? 7 : 8, run - 1);
      } else if (token >= 23) {
        int nzeros;
        if (token <= 27) nzeros = token - 23 + 1;
        else if (token == 28) nzeros = 6 + (eb & 3);
        else if (token == 29) nzeros = 10 + (eb & 7);
        else if (token == 30) nzeros = 1;
        else nzeros = 2 + (eb & 1);
        int t, e;
        combo_token(nzeros + 1, qc, &t, &e);
        log_token(es, pli, 0, t, e);
      } else {
        int t, e;
        if (combo_token(1, qc, &t, &e)) {
          log_token(es, pli, 0, t, e);
        } else {
          log_token(es, pli, 0, 7, 0);  // ZRL run of 1
          log_token(es, pli, zzi, token, eb);
        }
      }
    } else {
      log_token(es, pli, zzi, token, eb);
    }
  }
}

}  // namespace

extern "C" {

// Phase 1: plan one plane's blocks. dct/qdct: [n][64] int16 (qdct
// round-to-nearest in, AC rewritten to the chosen values out); dq0/dq1:
// intra/inter dequant rows; qti: per-block 0/1; nbt: [5][32] bit costs;
// outputs acbits[n], err2[n] (full-block coding error), paths [n][66][4].
static void trellis_plan_range(int64_t lo, int64_t hi, const int16_t* dct,
                               int16_t* qdct, const int32_t* dq0,
                               const int32_t* dq1, const int32_t* qti,
                               int64_t lam, const int64_t* nbt,
                               int64_t* acbits, int64_t* err2,
                               int16_t* paths, const int64_t* lam_b = nullptr) {
  for (int64_t i = lo; i < hi; i++) {
    const int32_t* dq = qti[i] ? dq1 : dq0;
    int16_t* row = qdct + i * 64;
    int16_t vals[64];
    acbits[i] = trellis_block(dct + i * 64, row, dq,
                              lam_b ? lam_b[i] : lam, qti[i] ? 0 : 3,
                              nbt, paths + i * 66 * 4, vals);
    int64_t e2 = 0;
    const int16_t* drow = dct + i * 64;
    for (int z = 1; z < 64; z++) row[z] = vals[z];
    for (int z = 0; z < 64; z++) {
      int64_t d = (int64_t)drow[z] - (int64_t)row[z] * dq[z];
      e2 += d * d;
    }
    err2[i] = e2;
  }
}

void th_trellis_plan_blocks(int64_t n, const int16_t* dct, int16_t* qdct,
                            const int32_t* dq0, const int32_t* dq1,
                            const int32_t* qti, int64_t lam,
                            const int64_t* nbt, int64_t* acbits,
                            int64_t* err2, int16_t* paths) {
  // Blocks are independent (cross-block EOB-run coupling lives in the
  // phase-2 replay): split large batches across cores.  Output ranges
  // are disjoint, so no synchronization is needed.
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = (int)(hw ? hw : 1);
  if (nthreads > 4) nthreads = 4;
  if (n < 4096 || nthreads < 2) {
    trellis_plan_range(0, n, dct, qdct, dq0, dq1, qti, lam, nbt, acbits,
                       err2, paths);
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; t++) {
    int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    ts.emplace_back(trellis_plan_range, lo, hi, dct, qdct, dq0, dq1, qti,
                    lam, nbt, acbits, err2, paths, nullptr);
  }
  for (auto& t : ts) t.join();
}

// Per-block-lambda variant: the activity-masking tier hands each block
// its own R/D lambda (rd_iscale semantics, analyze.c:1256-1340 --
// busy blocks prune harder, calm blocks keep more coefficients).
void th_trellis_plan_blocks_lam(int64_t n, const int16_t* dct,
                                int16_t* qdct, const int32_t* dq0,
                                const int32_t* dq1, const int32_t* qti,
                                const int64_t* lam_b, const int64_t* nbt,
                                int64_t* acbits, int64_t* err2,
                                int16_t* paths) {
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = (int)(hw ? hw : 1);
  if (nthreads > 4) nthreads = 4;
  if (n < 4096 || nthreads < 2) {
    trellis_plan_range(0, n, dct, qdct, dq0, dq1, qti, 0, nbt, acbits,
                       err2, paths, lam_b);
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; t++) {
    int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    ts.emplace_back(trellis_plan_range, lo, hi, dct, qdct, dq0, dq1, qti,
                    (int64_t)0, nbt, acbits, err2, paths, lam_b);
  }
  for (auto& t : ts) t.join();
}

// Phase 2: replay the plans and pack the residual section.
// Permuted variant: per-plane plan arrays stay in quantize (raster) order;
// perm maps scan position -> raster index, and dc values come per plane in
// scan order. Avoids the Python-side scatter/gather of the path tensors.
int64_t th_encode_frame_trellis_perm(
    const int16_t* paths0, const int16_t* paths1, const int16_t* paths2,
    const int32_t* perm0, const int32_t* perm1, const int32_t* perm2,
    const int32_t* dc0, const int32_t* dc1, const int32_t* dc2,
    const int64_t* ncoded, const int32_t* huff_codes, const uint8_t* prefix,
    int64_t prefix_bits, uint8_t* out, int64_t cap, int32_t* chosen_out) {
  EncStreams es;
  memset(es.eob_run, 0, sizeof(es.eob_run));
  memset(es.offs, 0, sizeof(es.offs));
  const int16_t* paths[3] = {paths0, paths1, paths2};
  const int32_t* perm[3] = {perm0, perm1, perm2};
  const int32_t* dc[3] = {dc0, dc1, dc2};
  for (int pli = 0; pli < 3; pli++)
    for (int64_t f = 0; f < ncoded[pli]; f++)
      emit_plan(es, pli, dc[pli][f],
                paths[pli] + (int64_t)perm[pli][f] * 66 * 4);
  return finish_and_pack(es, huff_codes, prefix, prefix_bits, out, cap,
                         chosen_out);
}

}  // extern "C"

// ===================================================================
// The host encoder's inter path (theora_tpu/native/entropy.cpp:1630-1968,
// 2136-2260, 2829-2873, 3258-3283): luma motion estimation (pyramid
// full-pel search, candidate propagation, half-pel and per-block
// refinement), the sequential mode decision with its per-fragment fill,
// the batch half-pel SAD, the MC residual gather against the
// reconstructed references and the per-block uncoded SSD.

// Split an independent per-block range across cores (outputs must be
// disjoint per index).
template <typename F>
static void th_parallel_range(int64_t n, int64_t grain, F&& body) {
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = (int)(hw ? hw : 1);
  if (nthreads > 4) nthreads = 4;
  if (n < grain || nthreads < 2) {
    body((int64_t)0, n);
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; t++) {
    int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    ts.emplace_back([&body, lo, hi] { body(lo, hi); });
  }
  for (auto& th : ts) th.join();
}
#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {
// MV offset tables (state.c:901-928).
const int8_t MVMAP_C[2][64] = {
    {-15, -15, -14, -14, -13, -13, -12, -12, -11, -11, -10, -10, -9, -9, -8,
     -8, -7, -7, -6, -6, -5, -5, -4, -4, -3, -3, -2, -2, -1, -1, 0, 0, 0,
     1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11,
     12, 12, 13, 13, 14, 14, 15, 15, 0},
    {-7, -7, -7, -7, -6, -6, -6, -6, -5, -5, -5, -5, -4, -4, -4, -4, -3, -3,
     -3, -3, -2, -2, -2, -2, -1, -1, -1, -1, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
     1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6, 6, 6, 7, 7,
     7, 7, 0}};
const int8_t MVMAP2_C[2][64] = {
    {-1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0,
     -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, -1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1,
     0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0},
    {-1, -1, -1, 0, -1, -1, -1, 0, -1, -1, -1, 0, -1, -1, -1, 0, -1, -1, -1,
     0, -1, -1, -1, 0, -1, -1, -1, 0, -1, -1, -1, 0, 1, 1, 1, 0, 1, 1, 1,
     0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1,
     1, 0}};
}  // namespace

// Single-block half-pel SAD (for sequential MV-predictor evaluation).
extern "C" int64_t th_sad_halfpel(const uint8_t* cur, int cur_stride,
                                  const uint8_t* ref, int ref_stride, int y,
                                  int x, int pad, int mvx, int mvy, int bs) {
  int mx = MVMAP_C[0][mvx + 31];
  int mx2 = MVMAP2_C[0][mvx + 31];
  int my = MVMAP_C[0][mvy + 31];
  int my2 = MVMAP2_C[0][mvy + 31];
  const uint8_t* c = cur + (int64_t)y * cur_stride + x;
  const uint8_t* s1 =
      ref + (int64_t)(y + pad + my) * ref_stride + x + pad + mx;
  int64_t sad = 0;
  if (mx2 | my2) {
    const uint8_t* s2 = s1 + (int64_t)my2 * ref_stride + mx2;
#if defined(__SSE2__)
    if (bs == 16) {
      // VP3 averages with truncation; pavgb rounds up, corrected by
      // subtracting (a ^ b) & 1 (the reference's frag_copy2 identity).
      __m128i acc = _mm_setzero_si128();
      const __m128i one = _mm_set1_epi8(1);
      for (int r = 0; r < 16;
           r++, c += cur_stride, s1 += ref_stride, s2 += ref_stride) {
        __m128i a = _mm_loadu_si128((const __m128i*)s1);
        __m128i b = _mm_loadu_si128((const __m128i*)s2);
        __m128i avg = _mm_sub_epi8(
            _mm_avg_epu8(a, b),
            _mm_and_si128(_mm_xor_si128(a, b), one));
        __m128i vc = _mm_loadu_si128((const __m128i*)c);
        acc = _mm_add_epi64(acc, _mm_sad_epu8(vc, avg));
      }
      return _mm_cvtsi128_si64(acc) +
             _mm_cvtsi128_si64(_mm_unpackhi_epi64(acc, acc));
    }
#endif
    for (int r = 0; r < bs; r++, c += cur_stride, s1 += ref_stride, s2 += ref_stride)
      for (int k = 0; k < bs; k++)
        sad += abs((int)c[k] - (((int)s1[k] + s2[k]) >> 1));
  } else {
#if defined(__SSE2__)
    if (bs == 16) {
      __m128i acc = _mm_setzero_si128();
      for (int r = 0; r < 16; r++, c += cur_stride, s1 += ref_stride) {
        __m128i vc = _mm_loadu_si128((const __m128i*)c);
        __m128i va = _mm_loadu_si128((const __m128i*)s1);
        acc = _mm_add_epi64(acc, _mm_sad_epu8(vc, va));
      }
      return _mm_cvtsi128_si64(acc) +
             _mm_cvtsi128_si64(_mm_unpackhi_epi64(acc, acc));
    }
#endif
    for (int r = 0; r < bs; r++, c += cur_stride, s1 += ref_stride)
      for (int k = 0; k < bs; k++) sad += abs((int)c[k] - s1[k]);
  }
  return sad;
}

// ===================================================================
// Motion estimation: pyramid full-pel search + spatial candidate
// propagation + half-pel refinement (the C++ twin of encode/mcenc.py; the
// reference's analogue is the candidate/square search of mcenc.c).
extern "C" {

namespace {

// SAD over an n x n block (n = 4, 8, or 16). The 8/16 paths use psadbw
// (one instruction per 16 pixels), the scalar loop autovectorizes for
// the rest -- the host-tier speed-of-light for the ME inner loop
// (mcenc.c's oc_enc_frag_sad analogue).
inline int64_t sad_block(const uint8_t* a, int as, const uint8_t* b, int bs_,
                         int n) {
#if defined(__SSE2__)
  if (n == 16) {
    __m128i acc = _mm_setzero_si128();
    for (int r = 0; r < 16; r++, a += as, b += bs_) {
      __m128i va = _mm_loadu_si128((const __m128i*)a);
      __m128i vb = _mm_loadu_si128((const __m128i*)b);
      acc = _mm_add_epi64(acc, _mm_sad_epu8(va, vb));
    }
    return _mm_cvtsi128_si64(acc) +
           _mm_cvtsi128_si64(_mm_unpackhi_epi64(acc, acc));
  }
  if (n == 8) {
    __m128i acc = _mm_setzero_si128();
    for (int r = 0; r < 8; r += 2, a += 2 * as, b += 2 * bs_) {
      __m128i va = _mm_unpacklo_epi64(
          _mm_loadl_epi64((const __m128i*)a),
          _mm_loadl_epi64((const __m128i*)(a + as)));
      __m128i vb = _mm_unpacklo_epi64(
          _mm_loadl_epi64((const __m128i*)b),
          _mm_loadl_epi64((const __m128i*)(b + bs_)));
      acc = _mm_add_epi64(acc, _mm_sad_epu8(va, vb));
    }
    return _mm_cvtsi128_si64(acc) +
           _mm_cvtsi128_si64(_mm_unpackhi_epi64(acc, acc));
  }
#endif
  int64_t s = 0;
  for (int r = 0; r < n; r++, a += as, b += bs_)
    for (int c = 0; c < n; c++) s += abs((int)a[c] - b[c]);
  return s;
}

void downsample(const uint8_t* src, int sw, int sh, uint8_t* dst) {
  int dw = sw / 2, dh = sh / 2;
  for (int y = 0; y < dh; y++)
    for (int x = 0; x < dw; x++) {
      const uint8_t* p = src + (int64_t)(2 * y) * sw + 2 * x;
      dst[(int64_t)y * dw + x] =
          (uint8_t)((p[0] + p[1] + p[sw] + p[sw + 1] + 2) >> 2);
    }
}

}  // namespace

// cur: [H, W]; ref: [H+2p, W+2p] padded; mb coords: [n] (unpadded, 16x16).
// Outputs: full-pel mvs [n][2] (dx, dy), sads [n].
void th_me_fullpel(const uint8_t* cur, int W, int H, const uint8_t* ref,
                   int pad, const int32_t* mby, const int32_t* mbx, int64_t n,
                   int32_t* mvs, int64_t* sads, int max_mv) {
  // Build pyramid level 1 (half) and 2 (quarter).
  std::vector<uint8_t> cur1(W / 2 * (H / 2)), cur2(W / 4 * (H / 4));
  int Wp = W + 2 * pad, Hp = H + 2 * pad;
  std::vector<uint8_t> ref1(Wp / 2 * (Hp / 2)), ref2(Wp / 4 * (Hp / 4));
  downsample(cur, W, H, cur1.data());
  downsample(cur1.data(), W / 2, H / 2, cur2.data());
  downsample(ref, Wp, Hp, ref1.data());
  downsample(ref1.data(), Wp / 2, Hp / 2, ref2.data());
  int pad2 = pad / 4, pad1 = pad / 2;
  int W2 = W / 4, W1 = W / 2;
  int Wp2 = Wp / 4, Wp1 = Wp / 2;
  th_parallel_range(n, 16, [&](int64_t lo_, int64_t hi_) {
  for (int64_t i = lo_; i < hi_; i++) {
    // Early termination (mcenc.c OC_YSAD_THRESH1): a near-perfect zero-MV
    // match skips the pyramid entirely.
    {
      const uint8_t* cb0 = cur + (int64_t)mby[i] * W + mbx[i];
      int64_t sz0 = sad_block(
          cb0, W, ref + (int64_t)(mby[i] + pad) * Wp + mbx[i] + pad, Wp, 16);
      if (sz0 < 256) {
        mvs[2 * i] = 0;
        mvs[2 * i + 1] = 0;
        sads[i] = sz0;
        continue;
      }
    }
    int y2 = mby[i] / 4, x2 = mbx[i] / 4;
    // Level 2: exhaustive +-4 over 4x4 blocks.
    int64_t best = INT64_MAX;
    int bdy = 0, bdx = 0;
    for (int dy = -4; dy <= 4; dy++)
      for (int dx = -4; dx <= 4; dx++) {
        int64_t s = sad_block(
            cur2.data() + (int64_t)y2 * W2 + x2, W2,
            ref2.data() + (int64_t)(y2 + pad2 + dy) * Wp2 + x2 + pad2 + dx,
            Wp2, 4);
        if (s < best) { best = s; bdy = dy; bdx = dx; }
      }
    int dy1 = bdy * 2, dx1 = bdx * 2;
    // Level 1: +-1 refine over 8x8 blocks.
    int y1 = mby[i] / 2, x1 = mbx[i] / 2;
    best = INT64_MAX;
    int rdy = dy1, rdx = dx1;
    for (int ey = -1; ey <= 1; ey++)
      for (int ex = -1; ex <= 1; ex++) {
        int ndy = dy1 + ey, ndx = dx1 + ex;
        if (ndy < -pad1 + 1 || ndy > pad1 - 1) continue;
        int64_t s = sad_block(
            cur1.data() + (int64_t)y1 * W1 + x1, W1,
            ref1.data() + (int64_t)(y1 + pad1 + ndy) * Wp1 + x1 + pad1 + ndx,
            Wp1, 8);
        if (s < best) { best = s; rdy = ndy; rdx = ndx; }
      }
    int dy0 = rdy * 2, dx0 = rdx * 2;
    if (dy0 > max_mv) dy0 = max_mv;
    if (dy0 < -max_mv) dy0 = -max_mv;
    if (dx0 > max_mv) dx0 = max_mv;
    if (dx0 < -max_mv) dx0 = -max_mv;
    // Level 0: compare against (0,0), then two refine passes (+-1, +-2).
    const uint8_t* cb = cur + (int64_t)mby[i] * W + mbx[i];
    int64_t s0 = sad_block(
        cb, W, ref + (int64_t)(mby[i] + pad + dy0) * Wp + mbx[i] + pad + dx0,
        Wp, 16);
    int64_t sz = sad_block(cb, W,
                           ref + (int64_t)(mby[i] + pad) * Wp + mbx[i] + pad,
                           Wp, 16);
    if (sz < s0) { s0 = sz; dy0 = 0; dx0 = 0; }
    for (int radius = 1; radius <= 2; radius++) {
      int bdy0 = dy0, bdx0 = dx0;
      for (int ey = -radius; ey <= radius; ey++)
        for (int ex = -radius; ex <= radius; ex++) {
          int ndy = dy0 + ey, ndx = dx0 + ex;
          if (ndy < -max_mv || ndy > max_mv || ndx < -max_mv || ndx > max_mv)
            continue;
          if (ndy == dy0 && ndx == dx0) continue;
          int64_t s = sad_block(
              cb, W,
              ref + (int64_t)(mby[i] + pad + ndy) * Wp + mbx[i] + pad + ndx,
              Wp, 16);
          if (s < s0) { s0 = s; bdy0 = ndy; bdx0 = ndx; }
        }
      dy0 = bdy0; dx0 = bdx0;
    }
    mvs[2 * i] = dx0;
    mvs[2 * i + 1] = dy0;
    sads[i] = s0;
  }
  });
}

// Spatial candidate propagation over the MB grid (in place).
void th_me_propagate(const uint8_t* cur, int W, int H, const uint8_t* ref,
                     int pad, const int32_t* mby, const int32_t* mbx,
                     int64_t n, int32_t* mvs, int64_t* sads, int max_mv,
                     int iters) {
  int Wp = W + 2 * pad;
  int R = 0, C = 0;
  for (int64_t i = 0; i < n; i++) {
    if (mby[i] / 16 + 1 > R) R = mby[i] / 16 + 1;
    if (mbx[i] / 16 + 1 > C) C = mbx[i] / 16 + 1;
  }
  std::vector<int64_t> grid((int64_t)R * C, -1);
  for (int64_t i = 0; i < n; i++)
    grid[(int64_t)(mby[i] / 16) * C + mbx[i] / 16] = i;
  const int drs[5] = {0, -1, -1, 0, 1};
  const int dcs[5] = {-1, 0, -1, 1, 0};
  for (int it = 0; it < iters; it++) {
    for (int64_t i = 0; i < n; i++) {
      int r = mby[i] / 16, c = mbx[i] / 16;
      const uint8_t* cb = cur + (int64_t)mby[i] * W + mbx[i];
      for (int k = 0; k < 5; k++) {
        int nr = r + drs[k], nc = c + dcs[k];
        if (nr < 0 || nr >= R || nc < 0 || nc >= C) continue;
        int64_t j = grid[(int64_t)nr * C + nc];
        if (j < 0) continue;
        int cdx = mvs[2 * j], cdy = mvs[2 * j + 1];
        if (cdx == mvs[2 * i] && cdy == mvs[2 * i + 1]) continue;
        int64_t s = sad_block(
            cb, W,
            ref + (int64_t)(mby[i] + pad + cdy) * Wp + mbx[i] + pad + cdx,
            Wp, 16);
        if (s < sads[i]) {
          sads[i] = s;
          mvs[2 * i] = cdx;
          mvs[2 * i + 1] = cdy;
        }
      }
      // +-1 refine.
      int dy0 = mvs[2 * i + 1], dx0 = mvs[2 * i];
      for (int ey = -1; ey <= 1; ey++)
        for (int ex = -1; ex <= 1; ex++) {
          int ndy = mvs[2 * i + 1] + ey, ndx = mvs[2 * i] + ex;
          if ((ey == 0 && ex == 0) || ndy < -max_mv || ndy > max_mv ||
              ndx < -max_mv || ndx > max_mv)
            continue;
          int64_t s = sad_block(
              cb, W,
              ref + (int64_t)(mby[i] + pad + ndy) * Wp + mbx[i] + pad + ndx,
              Wp, 16);
          if (s < sads[i]) { sads[i] = s; dy0 = ndy; dx0 = ndx; }
        }
      mvs[2 * i + 1] = dy0;
      mvs[2 * i] = dx0;
    }
  }
}

// Half-pel refinement (bs x bs blocks); mvs in/out: full-pel in -> half-pel.
void th_me_halfpel(const uint8_t* cur, int W, int H, const uint8_t* ref,
                   int pad, const int32_t* by, const int32_t* bx, int64_t n,
                   int bs, int32_t* mvs, int64_t* sads) {
  int Wp = W + 2 * pad;
  th_parallel_range(n, 64, [&](int64_t lo_, int64_t hi_) {
  for (int64_t i = lo_; i < hi_; i++) {
    int bdx = mvs[2 * i] * 2, bdy = mvs[2 * i + 1] * 2;
    // Early termination: a near-perfect full-pel match skips the
    // half-pel sites (mcenc.c OC_YSAD_THRESH1 scaled by area).
    {
      int64_t sf = th_sad_halfpel(cur, W, ref, Wp, by[i], bx[i], pad, bdx,
                                  bdy, bs);
      if (sf < (bs == 16 ? 256 : 64)) {
        mvs[2 * i] = bdx;
        mvs[2 * i + 1] = bdy;
        sads[i] = sf;
        continue;
      }
    }
    int64_t best = INT64_MAX;
    int fdx = bdx, fdy = bdy;
    for (int ey = -1; ey <= 1; ey++)
      for (int ex = -1; ex <= 1; ex++) {
        int ndx = bdx + ex, ndy = bdy + ey;
        if (ndx < -31 || ndx > 31 || ndy < -31 || ndy > 31) continue;
        int64_t s = th_sad_halfpel(cur, W, ref, Wp, by[i], bx[i], pad, ndx,
                                   ndy, bs);
        if (s < best) { best = s; fdx = ndx; fdy = ndy; }
      }
    mvs[2 * i] = fdx;
    mvs[2 * i + 1] = fdy;
    sads[i] = best;
  }
  });
}

}  // extern "C"

// +-radius full-pel refinement for arbitrary block size (in place).
extern "C" void th_me_refine(const uint8_t* cur, int W, int H,
                             const uint8_t* ref, int pad, const int32_t* by,
                             const int32_t* bx, int64_t n, int bs,
                             int32_t* mvs, int64_t* sads, int max_mv,
                             int radius) {
  int Wp = W + 2 * pad;
  th_parallel_range(n, 64, [&](int64_t lo_, int64_t hi_) {
  for (int64_t i = lo_; i < hi_; i++) {
    const uint8_t* cb = cur + (int64_t)by[i] * W + bx[i];
    int dx0 = mvs[2 * i], dy0 = mvs[2 * i + 1];
    int64_t s0 = sad_block(
        cb, W, ref + (int64_t)(by[i] + pad + dy0) * Wp + bx[i] + pad + dx0,
        Wp, bs);
    // Early termination on a near-perfect seed (mcenc.c OC_YSAD_THRESH1,
    // scaled by block area).
    if (s0 < (bs == 16 ? 256 : 64)) { sads[i] = s0; continue; }
    for (int ey = -radius; ey <= radius; ey++)
      for (int ex = -radius; ex <= radius; ex++) {
        int ndy = mvs[2 * i + 1] + ey, ndx = mvs[2 * i] + ex;
        if ((ey == 0 && ex == 0) || ndy < -max_mv || ndy > max_mv ||
            ndx < -max_mv || ndx > max_mv)
          continue;
        int64_t s = sad_block(
            cb, W, ref + (int64_t)(by[i] + pad + ndy) * Wp + bx[i] + pad + ndx,
            Wp, bs);
        if (s < s0) { s0 = s; dy0 = ndy; dx0 = ndx; }
      }
    mvs[2 * i] = dx0;
    mvs[2 * i + 1] = dy0;
    sads[i] = s0;
  }
  });
}

// ===================================================================
// Encoder mode decision + per-fragment fill (the sequential MB loop of
// encoder.py/_encode_inter; analyze.c:2288-2711 in spirit).
extern "C" {

// Inputs are per-valid-MB arrays of length n (mb order ascending):
//   sads: nomv, gold, intra, mv, mv4; mvs [n][2] half-pel best;
//   bmvs [n][4][2] per-block MVs; mb_fy/mb_fx pixel coords.
// cur/ref for predictor SAD evaluation.
// Outputs: mb_modes [n], mb_mvs [n][2], and per-fragment
// refi/mode/mv via mb_maps fill.
void th_mode_decide_fill(
    const uint8_t* cur, int W, int H, const uint8_t* ref, int pad,
    int64_t n, const int32_t* mb_list, const int32_t* mb_fy,
    const int32_t* mb_fx, const int64_t* sad_nomv, const int64_t* sad_gold,
    const int64_t* sad_intra, const int64_t* sad_mv, const int64_t* sad_4mv,
    const int32_t* mvs, const int32_t* bmvs, const int32_t* mb_maps,
    int pixel_fmt, double mv_bits_sad, double bias_scale,
    int32_t* mb_modes_out, int32_t* mb_mvs_out, int32_t* refi,
    int32_t* fmode, int32_t* fmv) {
  int last_x = 0, last_y = 0, prior_x = 0, prior_y = 0;
  const int* map_idxs = MB_MAP_IDXS_C[pixel_fmt];
  int map_nidxs = MB_MAP_NIDXS_C[pixel_fmt];
  for (int64_t i = 0; i < n; i++) {
    int mvx = mvs[2 * i], mvy = mvs[2 * i + 1];
    // Costs per candidate mode.
    double best_cost = (double)sad_nomv[i];
    int best_mode = 0;
    double c;
    c = (double)sad_intra[i] + 350 * bias_scale;
    if (c < best_cost) { best_cost = c; best_mode = 1; }
    c = (double)sad_gold[i] + 80 * bias_scale;
    if (c < best_cost) { best_cost = c; best_mode = 5; }
    c = (double)sad_4mv[i] + 640 * bias_scale + 4 * mv_bits_sad;
    if (c < best_cost) { best_cost = c; best_mode = 7; }
    if (mvx || mvy) {
      c = (double)sad_mv[i] + mv_bits_sad;
      if (c < best_cost) { best_cost = c; best_mode = 2; }
    }
    if (last_x || last_y) {
      int64_t s = (mvx == last_x && mvy == last_y)
                      ? sad_mv[i]
                      : th_sad_halfpel(cur, W, ref, W + 2 * pad, mb_fy[i],
                                       mb_fx[i], pad, last_x, last_y, 16);
      c = (double)s + 16 * bias_scale;
      if (c < best_cost) { best_cost = c; best_mode = 3; }
    }
    if ((prior_x || prior_y) && !(prior_x == last_x && prior_y == last_y)) {
      int64_t s = (mvx == prior_x && mvy == prior_y)
                      ? sad_mv[i]
                      : th_sad_halfpel(cur, W, ref, W + 2 * pad, mb_fy[i],
                                       mb_fx[i], pad, prior_x, prior_y, 16);
      c = (double)s + 24 * bias_scale;
      if (c < best_cost) { best_cost = c; best_mode = 4; }
    }
    int mbi = mb_list[i];
    mb_modes_out[i] = best_mode;
    int out_x = 0, out_y = 0;
    switch (best_mode) {
      case 2: out_x = mvx; out_y = mvy; prior_x = last_x; prior_y = last_y;
              last_x = mvx; last_y = mvy; break;
      case 3: out_x = last_x; out_y = last_y; break;
      case 4: {
        out_x = prior_x; out_y = prior_y;
        int tx = last_x, ty = last_y;
        last_x = prior_x; last_y = prior_y;
        prior_x = tx; prior_y = ty;
        break;
      }
      case 7: prior_x = last_x; prior_y = last_y;
              last_x = bmvs[(i * 4 + 3) * 2]; last_y = bmvs[(i * 4 + 3) * 2 + 1];
              break;
      default: break;
    }
    mb_mvs_out[2 * i] = out_x;
    mb_mvs_out[2 * i + 1] = out_y;
    // Per-fragment fill.
    const int32_t* mm = mb_maps + (int64_t)mbi * 12;
    int rf = FRAME_FOR_MODE_C[best_mode];
    if (best_mode == 7) {
      int lbx[4], lby[4];
      for (int bi = 0; bi < 4; bi++) {
        lbx[bi] = bmvs[(i * 4 + bi) * 2];
        lby[bi] = bmvs[(i * 4 + bi) * 2 + 1];
        int32_t f = mm[bi];
        if (f >= 0) {
          refi[f] = rf; fmode[f] = 7;
          fmv[2 * f] = lbx[bi]; fmv[2 * f + 1] = lby[bi];
        }
      }
      int cbx[4] = {0, 0, 0, 0}, cby[4] = {0, 0, 0, 0};
      if (pixel_fmt == 0) {
        cbx[0] = div_round_pow2(lbx[0] + lbx[1] + lbx[2] + lbx[3], 2, 2);
        cby[0] = div_round_pow2(lby[0] + lby[1] + lby[2] + lby[3], 2, 2);
      } else if (pixel_fmt == 2) {
        cbx[0] = div_round_pow2(lbx[0] + lbx[1], 1, 1);
        cby[0] = div_round_pow2(lby[0] + lby[1], 1, 1);
        cbx[2] = div_round_pow2(lbx[2] + lbx[3], 1, 1);
        cby[2] = div_round_pow2(lby[2] + lby[3], 1, 1);
      } else {
        for (int k = 0; k < 4; k++) { cbx[k] = lbx[k]; cby[k] = lby[k]; }
      }
      for (int mi = 4; mi < map_nidxs; mi++) {
        int mapi = map_idxs[mi];
        int bi = mapi & 3;
        int32_t f = mm[(mapi >> 2) * 4 + bi];
        if (f >= 0) {
          refi[f] = rf; fmode[f] = 7;
          fmv[2 * f] = cbx[bi]; fmv[2 * f + 1] = cby[bi];
        }
      }
    } else {
      for (int mi = 0; mi < map_nidxs; mi++) {
        int mapi = map_idxs[mi];
        int32_t f = mm[(mapi >> 2) * 4 + (mapi & 3)];
        if (f >= 0) {
          refi[f] = rf; fmode[f] = best_mode;
          fmv[2 * f] = out_x; fmv[2 * f + 1] = out_y;
        }
      }
    }
  }
}

}  // extern "C"

// Encoder hot helpers: batch half-pel SAD and the MC residual gather.
extern "C" {

void th_sad_batch(const uint8_t* cur, int W, const uint8_t* ref, int pad,
                  int64_t n, const int32_t* fy, const int32_t* fx,
                  const int32_t* mvx, const int32_t* mvy, int bs,
                  int64_t* out) {
  for (int64_t i = 0; i < n; i++)
    out[i] = th_sad_halfpel(cur, W, ref, W + 2 * pad, fy[i], fx[i], pad,
                            mvx[i], mvy[i], bs);
}

// Residuals for the encoder's closed loop: cur - prediction, where the
// prediction is 128 (intra), or a 1/2-pel MC read from the padded
// prev/gold reconstruction (the counterpart of decode-side recon;
// analyze.c:626-785 in spirit).
void th_enc_residuals(const uint8_t* cur, int W, const uint8_t* prevp,
                      const uint8_t* goldp, int Wp, int64_t n,
                      const int32_t* fy, const int32_t* fx,
                      const int32_t* refsel, const int32_t* o1y,
                      const int32_t* o1x, const int32_t* o2y,
                      const int32_t* o2x, const uint8_t* use2, int vpad,
                      int hpad, int32_t* out) {
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* c = cur + (int64_t)fy[i] * W + fx[i];
    int32_t* o = out + i * 64;
    if (refsel[i] == 0) {
      for (int r = 0; r < 8; r++, c += W)
        for (int k = 0; k < 8; k++) o[r * 8 + k] = (int32_t)c[k] - 128;
      continue;
    }
    const uint8_t* refp = refsel[i] == 1 ? prevp : goldp;
    const uint8_t* s1 = refp + (int64_t)(fy[i] + vpad + o1y[i]) * Wp +
                        fx[i] + hpad + o1x[i];
    if (use2[i]) {
      const uint8_t* s2 = refp + (int64_t)(fy[i] + vpad + o2y[i]) * Wp +
                          fx[i] + hpad + o2x[i];
      for (int r = 0; r < 8; r++, c += W, s1 += Wp, s2 += Wp)
        for (int k = 0; k < 8; k++)
          o[r * 8 + k] = (int32_t)c[k] - (((int)s1[k] + s2[k]) >> 1);
    } else {
      for (int r = 0; r < 8; r++, c += W, s1 += Wp)
        for (int k = 0; k < 8; k++) o[r * 8 + k] = (int32_t)c[k] - s1[k];
    }
  }
}

}  // extern "C"

// ===================================================================
// Per-8x8-block SSD of two planes (the uncoded-prediction skip cost,
// analyze.c:529-531 skip_ssd): out[bv*nbh+bh] = 16 * sum of squared
// differences over block (bv, bh).  cur is tightly packed [h, w];
// prev has row stride pstride (a padded reconstruction plane).
extern "C" void th_ssd8_plane(const uint8_t* cur, const uint8_t* prev,
                              int64_t h, int64_t w, int64_t pstride,
                              int64_t* out) {
  const int64_t nbh = w / 8;
  for (int64_t bv = 0; bv < h / 8; bv++) {
    for (int64_t bh = 0; bh < nbh; bh++) {
      int64_t acc = 0;
      const uint8_t* c = cur + (bv * 8) * w + bh * 8;
      const uint8_t* p = prev + (bv * 8) * pstride + bh * 8;
      for (int r = 0; r < 8; r++) {
        for (int k = 0; k < 8; k++) {
          const int d = (int)c[k] - (int)p[k];
          acc += d * d;
        }
        c += w;
        p += pstride;
      }
      out[bv * nbh + bh] = acc * 16;
    }
  }
}
