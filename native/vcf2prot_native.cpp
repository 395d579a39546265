// vcf2prot_tpu native frontend + compiler.
//
// C++ implementation of the host-side hot path: VCF record scan, per-sample
// bitmask decode, consequence parsing, the 22-opcode instruction compiler and
// Task-program emission, fused per haplotype into the structure-of-arrays
// device ABI. Semantics are ported 1:1 from the Python modules (which in turn
// mirror the Rust reference; citations in vcf2prot_tpu/frontend/*.py and
// vcf2prot_tpu/compiler/*.py) -- the Python path stays as the conformance
// oracle and tests assert byte equality between the two.
//
// Exposed as a CPython extension (no pybind11): one entry point,
// compile_cohort(...), returning per-haplotype SoA arrays as bytes objects.

// Building with -DVCF2PROT_NO_PYTHON yields a pure-C++ core (no Python.h,
// no bindings) for standalone sanitizer/unit harnesses (native/test_harness).
#ifndef VCF2PROT_NO_PYTHON
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#endif

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fstream>
#include <map>
#include <memory>
#include <mutex>
#include <sstream>
#include <stdexcept>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <chrono>
#include <cstdlib>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

using std::string;
using std::string_view;
using std::vector;

// ---------------------------------------------------------------- errors ---

struct FatalError : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct SkipTranscript : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// ------------------------------------------------------------- constants ---

enum MutType : int {
  MISSENSE = 0, S_MISSENSE, FRAMESHIFT, S_FRAMESHIFT,
  INFRAME_INSERTION, S_INFRAME_INSERTION, INFRAME_DELETION, S_INFRAME_DELETION,
  STOP_GAINED, STOP_LOST,
  S_MISSENSE_INFRAME, S_FRAMESHIFT_STOPRET, S_STOPGAIN_INFRAME,
  FRAMESHIFT_STOPRET, INFRAME_DEL_STOPRET, INFRAME_INS_STOPRET,
  STOPGAIN_INFRAME, START_LOST, S_STOP_GAINED, STOPLOST_FRAMESHIFT,
  MISSENSE_INFRAME, START_LOST_SPLICE,
  NUM_TYPES
};

const char* SUP_TYPE[NUM_TYPES] = {
    "missense", "*missense", "frameshift", "*frameshift",
    "inframe_insertion", "*inframe_insertion", "inframe_deletion",
    "*inframe_deletion", "stop_gained", "stop_lost",
    "*missense&inframe_altering", "*frameshift&stop_retained",
    "*stop_gained&inframe_altering", "frameshift&stop_retained",
    "inframe_deletion&stop_retained", "inframe_insertion&stop_retained",
    "stop_gained&inframe_altering", "start_lost", "*stop_gained",
    "stop_lost&frameshift", "missense&inframe_altering",
    "start_lost&splice_region"};

int lookup_type(string_view s) {
  static const std::unordered_map<string_view, int> table = [] {
    std::unordered_map<string_view, int> t;
    for (int i = 0; i < NUM_TYPES; ++i) t.emplace(SUP_TYPE[i], i);
    return t;
  }();
  auto it = table.find(s);
  return it == table.end() ? -1 : it->second;
}

// --------------------------------------------------------- string helpers ---

inline string_view field_before(string_view s, char sep) {
  size_t p = s.find(sep);
  return p == string_view::npos ? s : s.substr(0, p);
}

inline void split_into(string_view s, char sep, vector<string_view>* out) {
  out->clear();
  size_t start = 0;
  while (true) {
    size_t p = s.find(sep, start);
    if (p == string_view::npos) {
      out->push_back(s.substr(start));
      return;
    }
    out->push_back(s.substr(start, p - start));
    start = p + 1;
  }
}

// ---------------------------------------------------------- bitmask decode ---
// Mirrors text_parser.get_bit_mask + bitmask.decode_bitmask
// (reference: text_parser.rs:163-251, MaskDecoder.rs:32-153).

struct MaskIndices {
  vector<int> hap1, hap2;
  bool carrier = false;
};

bool parse_i64(string_view s, int64_t* out) {
  if (s.empty()) return false;
  size_t i = 0;
  bool neg = false;
  if (s[0] == '+' || s[0] == '-') {
    neg = s[0] == '-';
    i = 1;
    if (s.size() == 1) return false;
  }
  int64_t v = 0;
  for (; i < s.size(); ++i) {
    if (s[i] < '0' || s[i] > '9') return false;
    if (v > (INT64_MAX - 9) / 10) return false;  // overflow
    v = v * 10 + (s[i] - '0');
  }
  *out = neg ? -v : v;
  return true;
}

void decode_words(const vector<uint32_t>& words, MaskIndices* out) {
  int field_base = 0;
  for (uint32_t w : words) {
    int index = 0;
    while (w != 0) {
      if (w & 1u) out->hap1.push_back(field_base + index);
      if ((w >> 1) & 1u) out->hap2.push_back(field_base + index);
      w >>= 2;
      ++index;
    }
    field_base += 15;  // 15 two-bit entries per word (MaskDecoder.rs:150)
  }
  out->carrier = !out->hap1.empty() || !out->hap2.empty();
}

// Decode a sample column's bitmask sub-field (the text after the column's
// last ':'); returns carrier indices or not-a-carrier.
void decode_mask(string_view mask, MaskIndices* out) {
  out->hap1.clear();
  out->hap2.clear();
  out->carrier = false;
  if (mask == ".") return;
  if (mask.find(',') == string_view::npos) {
    int64_t v;
    if (!parse_i64(mask, &v)) return;
    if (v < INT32_MIN || v > INT32_MAX) return;  // i32 parse in the reference
    if (v < 0)
      throw FatalError("An invalid bit mask was encountered: " + string(mask));
    if (v == 0) return;  // "0$" decodes as reference
    decode_words({static_cast<uint32_t>(v)}, out);
    return;
  }
  // CSV: strip trailing ",0" words
  vector<string_view> parts;
  split_into(mask, ',', &parts);
  while (!parts.empty() && parts.back() == "0") parts.pop_back();
  if (parts.empty()) return;
  if (mask.find('-') != string_view::npos)
    throw FatalError("An invalid bit mask was encountered: " + string(mask));
  if (parts.size() == 1) {
    int64_t v;
    if (!parse_i64(parts[0], &v)) return;
    if (v < INT32_MIN || v > INT32_MAX) return;
    if (v < 0)
      throw FatalError("An invalid bit mask was encountered: " + string(mask));
    if (v == 0) return;
    decode_words({static_cast<uint32_t>(v)}, out);
    return;
  }
  vector<uint32_t> words;
  words.reserve(parts.size());
  for (auto p : parts) {
    int64_t v;
    // u32 parse: failure aborts (the reference unwraps; MaskDecoder.rs:47)
    if (!parse_i64(p, &v) || v < 0 || v > int64_t(UINT32_MAX))
      throw FatalError("unparseable bitmask word: " + string(p));
    words.push_back(static_cast<uint32_t>(v));
  }
  decode_words(words, out);
}

// ----------------------------------------------------- sample-column walk ---

struct CarrierCol {
  size_t sample, mask_off, mask_len;  // offsets into the sample region
};

#if defined(__x86_64__)
__attribute__((target("avx2"))) inline uint32_t sep_masks_avx2(
    const char* p, uint32_t* colons) {
  __m256i v = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p));
  *colons = static_cast<uint32_t>(_mm256_movemask_epi8(
      _mm256_cmpeq_epi8(v, _mm256_set1_epi8(':'))));
  return static_cast<uint32_t>(_mm256_movemask_epi8(
      _mm256_cmpeq_epi8(v, _mm256_set1_epi8('\t'))));
}

inline bool cpu_has_avx2() {
  static const bool ok = __builtin_cpu_supports("avx2");
  return ok;
}
#endif

// Walk the tab-separated sample columns of `region` (the record text after
// the FORMAT column), recording for each column the sub-field after its last
// ':' -- the candidate BCSQ bitmask (text_parser.rs:163-194 takes the last
// ':'-field). Columns with no ':' and the two overwhelmingly common
// non-carrier masks "." and "0" are dropped inline; everything else lands in
// `carriers` for the full decode. Returns the number of columns seen,
// stopping at n_samples (the reference reads exactly that many and ignores
// extra columns). SIMD path: 32-byte AVX2 blocks yield tab/colon bitmasks
// consumed bit-by-bit, so per-column cost is a few ctz/branch ops instead of
// a find() restart.
size_t walk_sample_columns(string_view region, size_t n_samples,
                           vector<CarrierCol>* carriers,
                           size_t skip_cols = 0) {
  carriers->clear();
  const char* base = region.data();
  const size_t n = region.size();
  size_t s = 0;
  size_t last_colon = SIZE_MAX;
  auto flush = [&](size_t col_end) {
    if (last_colon != SIZE_MAX) {
      size_t off = last_colon + 1, len = col_end - off;
      if (len > 1 || (len == 1 && base[off] != '.' && base[off] != '0'))
        carriers->push_back(CarrierCol{s, off, len});
      last_colon = SIZE_MAX;
    }
    ++s;
  };
  size_t i = 0;
  // sharded runs never decode the first `skip_cols` columns: count their
  // closing tabs at popcount speed (whole 32-byte blocks, no per-separator
  // bit walk, no carrier detection) before the carrier walk of the owned
  // range. `s` stays the GLOBAL column index.
#if defined(__x86_64__)
  if (skip_cols > 0 && cpu_has_avx2()) {
    while (i + 32 <= n && s < skip_cols) {
      uint32_t colons;
      uint32_t tabs = sep_masks_avx2(base + i, &colons);
      unsigned cnt = (unsigned)__builtin_popcount(tabs);
      if (s + cnt < skip_cols) {
        s += cnt;
        i += 32;
        continue;
      }
      // boundary block: step tab-by-tab up to the owned range
      while (tabs && s < skip_cols) {
        unsigned b = static_cast<unsigned>(__builtin_ctz(tabs));
        tabs &= tabs - 1;
        ++s;
        if (s == skip_cols) {
          i += b + 1;  // resume right after the tab closing the prefix
          goto carrier_walk;
        }
      }
      i += 32;
    }
  }
#endif
  for (; i < n && s < skip_cols; ++i)
    if (base[i] == '\t') ++s;
#if defined(__x86_64__)
carrier_walk:
  // tab-only bit stepping (round 5): iterate ONLY the tab bits; a column's
  // last ':' is recovered with one clz over the colon mask windowed to
  // [prev_tab+1, tab), so per-column cost no longer scales with the number
  // of ':' sub-fields (FORMAT columns carry several). Cross-block columns
  // carry last_colon via the post-loop tail window.
  if (cpu_has_avx2()) {
    while (i + 32 <= n && s < n_samples) {
      uint32_t colons;
      uint32_t tabs = sep_masks_avx2(base + i, &colons);
      unsigned prev = 0;
      while (tabs) {
        unsigned b = static_cast<unsigned>(__builtin_ctz(tabs));
        tabs &= tabs - 1;
        uint32_t win = colons & static_cast<uint32_t>(
            (((uint64_t)1 << b) - 1) & ~(((uint64_t)1 << prev) - 1));
        if (win) last_colon = i + (31u - (unsigned)__builtin_clz(win));
        flush(i + b);
        if (s == n_samples) return s;
        prev = b + 1;
      }
      uint32_t tail = colons & static_cast<uint32_t>(
          ~(((uint64_t)1 << prev) - 1));
      if (tail) last_colon = i + (31u - (unsigned)__builtin_clz(tail));
      i += 32;
    }
  }
#endif
  for (; i < n && s < n_samples; ++i) {
    char c = base[i];
    if (c == ':') {
      last_colon = i;
    } else if (c == '\t') {
      flush(i);
    }
  }
  if (s < n_samples) flush(n);  // final column ends at the region end
  return s;
}

// -------------------------------------------------------- mutation model ---

enum MsKind : int { SEQ = 0, END = 1, NOT = 2 };

struct MutatedString {
  // Residue text lives as a view into the VCF record text (alive through the
  // whole compile) for the overwhelmingly common `<digits><residues>` form;
  // `owned` is the fallback for interleaved-digit forms and is never pointed
  // into by `view` (so copies/moves stay safe). kind==NOT always has empty
  // text (the reference's lone-'*' case, mutation_ds.rs:71-100).
  int kind = NOT;
  string_view view;
  string owned;

  string_view text() const { return view.data() ? view : string_view(owned); }
  size_t size() const { return text().size(); }
  // residues minus any trailing '*'
  string_view payload() const {
    if (kind == SEQ) return text();
    if (kind == END) {
      string_view t = text();
      return t.substr(0, t.size() - 1);
    }
    throw SkipTranscript("NOT-sequence has no payload");
  }
  bool operator==(const MutatedString& o) const {
    return kind == o.kind && text() == o.text();
  }
};

struct Mutation {
  int type;
  string_view transcript;  // view into the VCF text (alive through compile)
  int64_t ref_pos, mut_pos;  // 0-based (u16-wrapped like the reference)
  MutatedString ref_aa, mut_aa;
};

// "35KTEST" -> (35, "KTEST"); digits anywhere; '-' rejected; u16 positions;
// an empty/digits-only residue side becomes the lone-'*' (NOT) kind
// (text_parser.rs:127-149, mutation_ds.rs:109-138). Allocation-free when the
// residues form one contiguous run after the digits (the real-data shape).
bool parse_aa_side(string_view s, int64_t* pos, MutatedString* out) {
  int64_t p = 0;
  bool have_digit = false;
  bool has_star = false;
  bool contiguous = true;
  size_t residue_start = string_view::npos;
  size_t n_res = 0;
  for (size_t i = 0; i < s.size(); ++i) {
    char c = s[i];
    if (c == '-') return false;
    if (c >= '0' && c <= '9') {
      have_digit = true;
      p = p * 10 + (c - '0');
      if (p > 0xFFFF) return false;  // u16 overflow fails the parse
      if (residue_start != string_view::npos) contiguous = false;
    } else {
      if (residue_start == string_view::npos) residue_start = i;
      if (c == '*') has_star = true;
      ++n_res;
    }
  }
  if (!have_digit) return false;
  *pos = p;
  out->view = {};
  out->owned.clear();
  if (n_res == 0 || (n_res == 1 && has_star)) {
    out->kind = NOT;  // empty side -> synthesized "*" -> NOT
    return true;
  }
  out->kind = has_star ? END : SEQ;
  if (contiguous) {
    out->view = s.substr(residue_start);
  } else {
    out->owned.reserve(n_res);
    for (char c : s)
      if (c < '0' || c > '9') out->owned.push_back(c);
  }
  return true;
}

// returns false if the mutation should be silently dropped; `scratch` is a
// caller-provided split buffer (hoisted out of the per-mutation hot loop)
bool parse_mutation(string_view csq, Mutation* m,
                    vector<string_view>* scratch) {
  // split_csq_string: 6 pipes + protein_coding/NMD, or short-form start_lost
  auto& f = *scratch;
  split_into(csq, '|', &f);
  if (f.size() == 7) {
    if (f[3] != "protein_coding" && f[3] != "NMD") return false;
    int t = lookup_type(f[0]);
    if (t < 0) return false;
    string_view aa_s = f[5];
    size_t gt = aa_s.find('>');
    if (gt == string_view::npos ||
        aa_s.find('>', gt + 1) != string_view::npos)
      return false;
    int64_t rp, mp;
    if (!parse_aa_side(aa_s.substr(0, gt), &rp, &m->ref_aa)) return false;
    if (!parse_aa_side(aa_s.substr(gt + 1), &mp, &m->mut_aa)) return false;
    m->type = t;
    m->transcript = f[2];
    m->ref_pos = (rp - 1) & 0xFFFF;  // u16 wrap (mutation_ds.rs:137)
    m->mut_pos = (mp - 1) & 0xFFFF;
    return true;
  }
  if (!f.empty() && f[0] == "start_lost" && f.size() >= 3) {
    // short form synthesizes "1M>1*" (text_parser.rs:43-49)
    static const char kM[] = "M";
    m->type = START_LOST;
    m->transcript = f[2];
    m->ref_pos = 0;
    m->mut_pos = 0;
    m->ref_aa = MutatedString{SEQ, string_view(kM, 1), {}};
    m->mut_aa = MutatedString{NOT, {}, {}};
    return true;
  }
  return false;
}

// One per-haplotype csq reference, with its transcript name pre-resolved at
// DECODE time (once per record entry, not once per carrier): a shared
// cohort repeats the same entry across thousands of carrier haplotypes, and
// per-carrier name resolution (even memoized) measurably dominated the
// compile stage (gprof: ~24% in the per-csq memo's hashtable find alone).
// ``ok`` is false when the entry fails the full mutation parse (wrong
// biotype / malformed AA field) -- grouping skips those, exactly like the
// old per-carrier parse failure path. ``ok`` is a separate flag because an
// EMPTY transcript name is a legal parse outcome (groups under "", same as
// the Python oracle) and must not read as a failure.
struct HapCsq {
  string_view csq;
  string_view name;
  bool ok;
};

// ------------------------------------------------------- instruction ISA ---
// Port of vcf2prot_tpu/compiler/instruction.py (itself mirroring
// instruction.rs:64-1098).

struct Instruction {
  char code = 'E';
  bool s_state = false;
  int64_t pos_ref = 0, pos_res = 0, length = 0;
  string data;
  bool is_phi() const { return code == 'E'; }
};

const Instruction PHI{};

bool validate_s_state(const Mutation& m, const vector<Mutation>& muts) {
  size_t index = 0;
  for (; index < muts.size(); ++index)
    if (muts[index].mut_pos == m.mut_pos) break;
  for (size_t i = 0; i < index; ++i) {
    const Mutation& p = muts[i];
    if (p.type == STOP_GAINED || p.type == FRAMESHIFT || p.type == S_STOP_GAINED)
      return false;
    if ((p.type == INFRAME_INSERTION || p.type == INFRAME_DELETION) &&
        (p.mut_aa.kind == NOT || p.mut_aa.kind == END))
      return false;
  }
  return true;
}

Instruction i_stop_gained(const Mutation& m) {
  return Instruction{'G', false, m.ref_pos, m.mut_pos, 0, ""};
}

Instruction i_missense(const Mutation& m) {
  if (m.mut_aa.kind == NOT) throw SkipTranscript("cannot interpret missense");
  string data(m.mut_aa.payload());
  return Instruction{'M', false, m.ref_pos, m.mut_pos, 1, std::move(data)};
}

Instruction i_frameshift(const Mutation& m) {
  if (m.mut_aa.kind == NOT) return PHI;
  string data(m.mut_aa.payload());
  int64_t n = (int64_t)data.size();
  return Instruction{'F', false, m.ref_pos, m.mut_pos, n, std::move(data)};
}

Instruction i_stop_lost(const Mutation& m) {
  if (m.mut_aa.kind == NOT) throw SkipTranscript("cannot interpret stop_lost");
  string data(m.mut_aa.payload());
  int64_t n = (int64_t)data.size();
  return Instruction{'L', false, m.ref_pos, m.mut_pos, n, std::move(data)};
}

// '2'/'3' replace: pos_ref/pos_res swapped (instruction.rs:270-273)
Instruction i_replace_2_or_3(const Mutation& m) {
  string data(m.mut_aa.payload());
  string ref_seq(m.ref_aa.payload());
  int64_t pos_ref = m.mut_pos, pos_res = m.ref_pos;
  if (data.size() != ref_seq.size())
    return Instruction{'3', false, pos_ref, pos_res,
                       (int64_t)ref_seq.size(), std::move(data)};
  int64_t n = (int64_t)data.size();
  return Instruction{'2', false, pos_ref, pos_res, n, std::move(data)};
}

Instruction i_inframe_insertion(const Mutation& m) {
  if (m.ref_aa.kind == SEQ) {
    if (m.ref_aa.size() != 1) {
      if (m.mut_aa.kind == NOT) return i_stop_gained(m);
      return i_replace_2_or_3(m);
    }
  } else if (m.ref_aa.kind == END) {
    return i_frameshift(m);
  } else {
    throw SkipTranscript("inframe insertion with lone-'*' reference side");
  }
  if (m.mut_aa.kind == SEQ) {
    string data(m.mut_aa.text());
    int64_t n = (int64_t)data.size();
    return Instruction{'I', false, m.ref_pos, m.mut_pos, n, std::move(data)};
  }
  if (m.mut_aa.kind == END) return i_frameshift(m);
  return i_stop_gained(m);
}

Instruction i_inframe_deletion(const Mutation& m) {
  int64_t del_span;
  if (m.ref_aa.kind == SEQ)
    del_span = (int64_t)m.ref_aa.size();
  else if (m.ref_aa.kind == END)
    del_span = (int64_t)m.ref_aa.size() - 1;
  else
    return i_stop_gained(m);
  string data;
  if (m.mut_aa.kind == SEQ) {
    if (m.mut_aa.size() == 1)
      data = string(m.mut_aa.text());
    else
      return i_replace_2_or_3(m);
  } else if (m.mut_aa.kind == END) {
    data = string(m.mut_aa.payload());
    if (data.size() != 1) return i_frameshift(m);
  } else {
    return i_stop_gained(m);
  }
  int64_t n = del_span - (int64_t)data.size();
  return Instruction{'D', false, m.ref_pos, m.mut_pos, n, std::move(data)};
}

Instruction relabel(Instruction ins, char code) {
  if (!ins.is_phi()) ins.code = code;
  return ins;
}

Instruction i_s_frameshift(const Mutation& m, const vector<Mutation>& muts) {
  if (!validate_s_state(m, muts)) return PHI;
  if (m.mut_aa.kind == NOT) return i_stop_gained(m);
  Instruction b = i_frameshift(m);
  if (b.is_phi()) return b;
  b.code = 'R';
  b.s_state = true;
  return b;
}

Instruction i_s_stop_gained(const Mutation& m, const vector<Mutation>& muts) {
  if (!validate_s_state(m, muts)) return PHI;
  Instruction b = i_stop_gained(m);
  b.code = 'X';
  b.s_state = true;
  return b;
}

Instruction from_mutation(const Mutation& m, const vector<Mutation>& muts) {
  switch (m.type) {
    case MISSENSE:
      return i_missense(m);
    case S_MISSENSE: {
      if (!validate_s_state(m, muts)) return PHI;
      Instruction b = i_missense(m);
      b.code = 'N';
      b.s_state = true;
      return b;
    }
    case FRAMESHIFT:
      return i_frameshift(m);
    case S_FRAMESHIFT:
      return i_s_frameshift(m, muts);
    case INFRAME_INSERTION:
      return i_inframe_insertion(m);
    case S_INFRAME_INSERTION: {
      if (!validate_s_state(m, muts)) return PHI;
      Instruction b = i_inframe_insertion(m);
      if (b.code == 'I') {
        b.code = 'J';
        b.s_state = true;
      }
      return b;
    }
    case INFRAME_DELETION:
      return i_inframe_deletion(m);
    case S_INFRAME_DELETION: {
      if (!validate_s_state(m, muts)) return PHI;
      // unconditional relabel (instruction.rs:499-501)
      Instruction b = i_inframe_deletion(m);
      b.code = 'C';
      b.s_state = true;
      return b;
    }
    case START_LOST:
      return Instruction{'0', false, 0, 0, 0, ""};
    case STOP_LOST:
      return i_stop_lost(m);
    case STOP_GAINED:
      return i_stop_gained(m);
    case S_STOP_GAINED:
      return i_s_stop_gained(m, muts);
    case S_MISSENSE_INFRAME:
      return relabel(i_s_frameshift(m, muts), 'K');
    case S_FRAMESHIFT_STOPRET: {
      if (m.mut_aa.kind == NOT) {
        if (!validate_s_state(m, muts)) return PHI;
        return Instruction{'Q', true, m.ref_pos, m.mut_pos, 0, ""};
      }
      return i_s_frameshift(m, muts);
    }
    case S_STOPGAIN_INFRAME:
      return relabel(i_s_stop_gained(m, muts), 'A');
    case FRAMESHIFT_STOPRET:
      return relabel(i_frameshift(m), 'B');
    case INFRAME_DEL_STOPRET: {
      Instruction b = i_stop_gained(m);
      b.code = 'P';
      if (m.ref_aa.kind == END)
        b.length = (int64_t)m.ref_aa.size() - 1;
      return b;
    }
    case INFRAME_INS_STOPRET:
      return PHI;  // always phi (instruction.rs:908-921)
    case STOPGAIN_INFRAME:
      return relabel(i_stop_gained(m), 'T');
    case STOPLOST_FRAMESHIFT:
      return m.ref_aa.kind == NOT ? i_stop_lost(m) : i_frameshift(m);
    case MISSENSE_INFRAME:
      if (m.mut_aa.kind == NOT) return i_frameshift(m);  // -> phi
      return i_replace_2_or_3(m);
    case START_LOST_SPLICE:
      return relabel(Instruction{'0', false, 0, 0, 0, ""}, 'U');
    default:
      throw FatalError("unsupported mutation type");
  }
}

// ---------------------------------------------------- transcript compiler ---
// Port of vcf2prot_tpu/compiler/transcript.py (mirroring
// transcript_instructions.rs:41-781).

struct Task {
  uint8_t exe;
  int64_t src, len, dst;
};
const Task NULL_TASK{2, 0, 0, 0};

struct TranscriptProgram {
  vector<Task> tasks;  // AoS during construction; cleared by finalize_soa()
  // SoA mirror: a compiled program is emitted into every carrier haplotype
  // (thousands of times on shared-variant cohorts), and SoA lets the
  // emission be bulk appends + vectorized offset adds instead of a
  // per-task AoS gather
  vector<uint8_t> exe_v;
  vector<int64_t> src_v, len_v, dst_v;
  string alt;
  int64_t res_len = 0;
  bool erased = false;

  void finalize_soa() {
    size_t n = tasks.size();
    exe_v.resize(n);
    src_v.resize(n);
    len_v.resize(n);
    dst_v.resize(n);
    for (size_t i = 0; i < n; ++i) {
      exe_v[i] = tasks[i].exe;
      src_v[i] = tasks[i].src;
      len_v[i] = tasks[i].len;
      dst_v[i] = tasks[i].dst;
    }
    tasks.clear();
    tasks.shrink_to_fit();
  }
};

inline bool in_set(char c, const char* set) {
  return std::strchr(set, c) != nullptr;
}

// opcode sets (transcript_instructions.rs:486,496; suppression :223-297)
const char* TERMINAL_ONLY = "KQABPZTWGFRL";
const char* NO_TAIL_COPY = "KYQABPZTWGFRLX";
const char* SUPPRESSIBLE = "RJCKQA";

struct QcFlags {
  bool inspect_ins_gen = true;
  bool inspect_txp = true;
  bool panic_on_err = true;
};

void inspect_instruction_generation(const vector<Instruction>& ins,
                                    const QcFlags& qc) {
  auto fail = [&](const char* msg) {
    if (qc.panic_on_err) throw FatalError(msg);
    throw SkipTranscript(msg);
  };
  {
    vector<int64_t> starts;
    starts.reserve(ins.size());
    for (auto& i : ins) starts.push_back(i.pos_ref);
    std::sort(starts.begin(), starts.end());
    if (std::adjacent_find(starts.begin(), starts.end()) != starts.end())
      fail("multiple mutations at the same position");
  }
  if (ins.size() > 1) {
    for (auto& i : ins)
      if (i.code == '0') return;
    for (size_t k = 0; k + 1 < ins.size(); ++k) {
      const Instruction& a = ins[k];
      const Instruction& b = ins[k + 1];
      // u64 wrap-around intentionally mirrors the release binary
      uint64_t bound = (uint64_t)a.pos_res + (uint64_t)a.data.size() - 1;
      if ((uint64_t)b.pos_res <= bound) fail("mutations overlap");
      if (a.code == 'C' || a.code == 'D') {
        uint64_t dbound = (uint64_t)a.pos_res + (uint64_t)a.length - 1;
        if ((uint64_t)b.pos_ref <= dbound) fail("deletion-range overlap");
      }
    }
  }
}

int64_t expected_results_size(const vector<Instruction>& ins, int64_t ref_len) {
  int64_t delta = 0;
  for (size_t idx = 0; idx < ins.size(); ++idx) {
    const Instruction& i = ins[idx];
    char c = i.code;
    if (c == 'U' || c == '0') {
      delta -= ref_len;
      break;
    }
    if (in_set(c, SUPPRESSIBLE)) {
      bool suppressed = false;
      for (size_t p = 0; p < idx; ++p)
        if (ins[p].code == 'G' || ins[p].code == 'F') {
          suppressed = true;
          break;
        }
      if (suppressed) continue;
    }
    int64_t dl = (int64_t)i.data.size();
    switch (c) {
      case 'F': case 'R': case 'K': case 'Q':
        delta += dl - (ref_len - i.pos_ref);
        break;
      case 'G': case 'X': case 'A': case 'T':
        delta -= ref_len - i.pos_ref;
        break;
      case 'M': case 'N': case '2': case 'Z':
        break;
      case 'L':
        if (i.pos_ref + 1 == ref_len || i.pos_ref == ref_len)
          delta += dl;
        else
          delta += dl - (ref_len - i.pos_ref);
        break;
      case 'I': case 'J':
        delta += dl - 1;
        break;
      case 'D': case 'C': case 'P':
        delta -= i.length;
        break;
      case 'B':
        delta -= ref_len - i.pos_ref - i.length;
        break;
      case 'W':
        delta += dl;
        break;
      case 'Y':
        delta += dl - (ref_len - i.pos_ref) + 1;
        break;
      case '3':
        delta += dl - i.length;
        break;
      default:
        throw SkipTranscript("instruction is not supported");
    }
  }
  return ref_len + delta;
}

Task build_base_task(const Instruction& first, int64_t ref_len) {
  if (first.code == 'Z' || first.code == 'Y')
    return Task{0, 0, first.pos_ref + 1, 0};
  if (first.code == 'L') {
    if (first.pos_ref + 1 == ref_len) return Task{0, 0, first.pos_ref + 1, 0};
    if (first.pos_ref == ref_len) return Task{0, 0, first.pos_ref, 0};
    return Task{0, 0, first.pos_res, 0};
  }
  return Task{0, 0, first.pos_ref, 0};
}

inline int64_t next_dst(const vector<Task>& tasks) {
  const Task& last = tasks.back();
  return last.dst + last.len;
}

Task task_missense(const Instruction& i, string* alt, const vector<Task>& tasks) {
  int64_t dst = next_dst(tasks);
  // doubled payload append, pointer at the second copy
  // (transcript_instructions.rs:659-661)
  alt->append(i.data);
  alt->append(i.data);
  int64_t pos_alt = (int64_t)alt->size() - (int64_t)i.data.size();
  return Task{1, pos_alt, 1, dst};
}

Task task_frameshift(const Instruction& i, string* alt, const vector<Task>& tasks) {
  int64_t dst = next_dst(tasks);
  alt->append(i.data);
  int64_t pos_alt = (int64_t)alt->size() - (int64_t)i.data.size();
  return Task{1, pos_alt, i.length, dst};
}

Task task_stop_lost(const Instruction& i, string* alt, const vector<Task>& tasks) {
  int64_t dst = next_dst(tasks);
  alt->append(i.data);
  int64_t pos_alt = (int64_t)alt->size() - (int64_t)i.data.size();
  return Task{1, pos_alt, (int64_t)i.data.size(), dst};
}

Task task_append_before(const Instruction& i, string* alt,
                        const vector<Task>& tasks, bool use_length) {
  int64_t pos_alt = (int64_t)alt->size();
  int64_t dst = next_dst(tasks);
  alt->append(i.data);
  return Task{1, pos_alt, use_length ? i.length : (int64_t)i.data.size(), dst};
}

Task add_last_task(int64_t ref_len, const Instruction& i, int64_t dst) {
  if (i.code == 'D' || i.code == 'C')
    return Task{0, i.pos_ref + i.length + 1,
                ref_len - i.pos_ref - i.length - 1, dst};
  if (i.code == '2' || i.code == '3')
    return Task{0, i.pos_ref + i.length, ref_len - i.pos_ref - i.length, dst};
  return Task{0, i.pos_ref + 1, ref_len - i.pos_ref - 1, dst};
}

Task add_till_next(const Instruction& i, size_t idx,
                   const vector<Instruction>& ins, const Task& last_task,
                   int64_t ref_len) {
  const Instruction& nxt = ins[idx + 1];
  int64_t dst = last_task.dst + last_task.len;
  if (i.code == 'D' || i.code == 'C') {
    if (nxt.pos_ref == i.pos_ref) return NULL_TASK;
    if (i.pos_ref + i.length == nxt.pos_ref) return NULL_TASK;
    int64_t start = i.pos_ref + i.length + 1;
    if (nxt.code == 'L' && nxt.pos_ref + 1 == ref_len && start == nxt.pos_ref)
      return Task{0, start, 1, dst};
    int64_t span = nxt.pos_ref - start;
    if (span < 0) throw SkipTranscript("negative gap span after deletion");
    return Task{0, start, span, dst};
  }
  if (i.code == '2' || i.code == '3') {
    if (nxt.pos_ref == i.pos_ref) return NULL_TASK;
    if (i.pos_ref + i.length == nxt.pos_ref) return NULL_TASK;
    int64_t start = i.pos_ref + i.length;
    return Task{0, start, nxt.pos_ref - start, dst};
  }
  if (nxt.pos_ref == i.pos_ref) return NULL_TASK;
  if (nxt.code == 'L') {
    if (nxt.pos_ref + 1 == ref_len)
      return Task{0, i.pos_ref + 1, nxt.pos_ref - i.pos_ref, dst};
    return Task{0, i.pos_ref + 1, nxt.pos_ref - 1 - i.pos_ref, dst};
  }
  int64_t span = nxt.pos_ref - 1 - i.pos_ref;
  if (span < 0) throw SkipTranscript("negative gap span");
  return Task{0, i.pos_ref + 1, span, dst};
}

TranscriptProgram compile_transcript(vector<Mutation>& muts, int64_t ref_len,
                                     const QcFlags& qc) {
  // sort by mutated position (stable, like the reference sort)
  std::stable_sort(muts.begin(), muts.end(),
                   [](const Mutation& a, const Mutation& b) {
                     return a.mut_pos < b.mut_pos;
                   });
  vector<Instruction> ins;
  ins.reserve(muts.size());
  for (const Mutation& m : muts) {
    Instruction i = from_mutation(m, muts);
    if (!i.is_phi()) ins.push_back(std::move(i));
  }
  if (ins.empty())
    throw SkipTranscript("no supported mutations in transcript");
  if (qc.inspect_ins_gen) inspect_instruction_generation(ins, qc);

  TranscriptProgram prog;
  bool erased = false;
  for (auto& i : ins)
    if (i.code == '0' || i.code == 'U') erased = true;
  if (erased) {
    prog.erased = true;
    return prog;
  }
  prog.res_len = expected_results_size(ins, ref_len);
  prog.tasks.push_back(build_base_task(ins[0], ref_len));
  for (size_t idx = 0; idx < ins.size(); ++idx) {
    const Instruction& i = ins[idx];
    char c = i.code;
    Task ins_task;
    if (c == 'M' || c == 'N')
      ins_task = task_missense(i, &prog.alt, prog.tasks);
    else if (c == 'F' || c == 'R' || c == 'K' || c == 'B' || c == 'Y')
      ins_task = task_frameshift(i, &prog.alt, prog.tasks);
    else if (c == 'G' || c == 'X' || c == 'A' || c == 'T')
      ins_task = NULL_TASK;
    else if (c == 'L' || c == 'W')
      ins_task = task_stop_lost(i, &prog.alt, prog.tasks);
    else if (c == 'I' || c == 'J')
      ins_task = task_append_before(i, &prog.alt, prog.tasks, true);
    else if (c == 'D' || c == 'C')
      ins_task = task_append_before(i, &prog.alt, prog.tasks, false);
    else if (c == 'Q' || c == 'Z' || c == 'P')
      ins_task = NULL_TASK;
    else if (c == '2')
      ins_task = task_append_before(i, &prog.alt, prog.tasks, true);
    else if (c == '3')
      ins_task = task_append_before(i, &prog.alt, prog.tasks, false);
    else
      throw SkipTranscript("instruction is not supported");

    Task gap;
    bool last = idx + 1 == ins.size();
    if (last) {
      if (in_set(c, NO_TAIL_COPY))
        gap = NULL_TASK;
      else
        gap = add_last_task(ref_len, i, ins_task.dst + ins_task.len);
    } else {
      if (in_set(c, TERMINAL_ONLY))
        throw SkipTranscript("instruction must be the last in a transcript");
      gap = add_till_next(i, idx, ins, ins_task, ref_len);
    }
    if (ins_task.exe != 2) prog.tasks.push_back(ins_task);
    if (gap.exe != 2) prog.tasks.push_back(gap);
  }
  // reference-stream reads must stay inside the transcript's span (the
  // reference binary aborts on out-of-range positions; this build skips)
  for (const Task& t : prog.tasks) {
    if (t.exe == 0 && (t.src < 0 || t.src + t.len > ref_len))
      throw SkipTranscript(
          "mutation positions exceed the reference sequence "
          "(annotation/proteome version mismatch?)");
  }
  if (prog.res_len < 0)
    throw SkipTranscript("negative expected output size");
  if (qc.inspect_txp) {
    int64_t counter = prog.tasks.empty() ? 0 : prog.tasks[0].len;
    for (size_t k = 1; k < prog.tasks.size(); ++k) {
      if (prog.tasks[k].dst != prog.tasks[k - 1].dst + prog.tasks[k - 1].len)
        throw FatalError("non-contiguous result tape in transcript program");
      counter += prog.tasks[k].len;
    }
    if (counter != prog.res_len)
      throw FatalError("transcript program size mismatch");
  }
  // filler / clamp (mirrors transcript.py get_g_rep tail handling)
  int64_t coverage =
      prog.tasks.empty() ? 0 : prog.tasks.back().dst + prog.tasks.back().len;
  if (coverage < prog.res_len) {
    int64_t gap = prog.res_len - coverage;
    int64_t pos_alt = (int64_t)prog.alt.size();
    prog.alt.append((size_t)gap, '.');
    prog.tasks.push_back(Task{1, pos_alt, gap, coverage});
  } else if (coverage > prog.res_len) {
    while (!prog.tasks.empty() && prog.tasks.back().dst >= prog.res_len)
      prog.tasks.pop_back();
    if (!prog.tasks.empty()) {
      Task& lastt = prog.tasks.back();
      int64_t overhang = lastt.dst + lastt.len - prog.res_len;
      if (overhang > 0) lastt.len -= overhang;
    }
  }
  prog.finalize_soa();
  return prog;
}

// ------------------------------------------------- grouping + drop_replicate

// Group one haplotype's csq entries by transcript; returns transcript-name ->
// mutation list in sorted-name order, mirroring maps.group_muts_per_transcript
// (incl. the substring capture when transcript-id lengths differ).
struct TranscriptGroup {
  string_view name;
  vector<Mutation> muts;
  vector<string_view> csqs;  // source csq strings (compile-memo identity)
};

void drop_replicate(TranscriptGroup* g) {
  auto& alts = g->muts;
  // one mutation can neither duplicate nor conflict; most groups are this
  // size, and skipping them avoids a per-group heap allocation (refs)
  if (alts.size() <= 1) return;
  std::stable_sort(alts.begin(), alts.end(),
                   [](const Mutation& a, const Mutation& b) {
                     return a.mut_pos < b.mut_pos;
                   });
  std::vector<int64_t> refs;
  refs.reserve(alts.size());
  for (auto& m : alts) refs.push_back(m.ref_pos);
  std::sort(refs.begin(), refs.end());
  size_t unique_n =
      std::unique(refs.begin(), refs.end()) - refs.begin();
  if (unique_n < alts.size()) {
    vector<Mutation> dedup;
    for (auto& m : alts) {
      if (!dedup.empty()) {
        const Mutation& p = dedup.back();
        if (p.type == m.type && p.ref_pos == m.ref_pos &&
            p.mut_pos == m.mut_pos && p.ref_aa == m.ref_aa &&
            p.mut_aa == m.mut_aa)
          continue;
      }
      dedup.push_back(m);
    }
    alts.swap(dedup);
    if (unique_n != alts.size())
      throw FatalError("Conflicting mutations in transcript " + string(g->name));
  }
}

// Grouping consumes decode-time-annotated HapCsq entries: the transcript
// name per entry was resolved once per RECORD during decode, so assembling
// a haplotype's per-transcript groups is pure pointer work -- no string
// parsing, no memo lookups, no per-carrier cost proportional to csq text.
//
// Two variants share the exact two-pass structure (including the
// reference's substring-capture quirk, vcf_tools.rs:89-92):
//  * group_by_transcript: eager -- also parses each valid entry's Mutation
//    and runs the dedup/conflict gate (drop_replicate). Used by the pool
//    probe and whenever the compile path needs muts up front.
//  * group_by_transcript_lazy: names only, NO muts, NO dedup; muts
//    materialize per group only on compile-memo misses (materialize_group),
//    which is behavior-equivalent because identical bundles dedup/abort
//    identically on their first occurrence.

vector<TranscriptGroup> group_assemble(const vector<HapCsq>& csqs,
                                       bool eager) {
  std::unordered_map<string_view, size_t> index_of;
  vector<string_view> scratch;
  vector<TranscriptGroup> groups;
  vector<size_t> parsed_group(csqs.size(), SIZE_MAX);
  bool multi_len = false;
  size_t first_len = SIZE_MAX;
  for (size_t i = 0; i < csqs.size(); ++i) {
    if (!csqs[i].ok) continue;  // failed the decode-time mutation parse
    string_view name = csqs[i].name;
    auto [it, inserted] = index_of.emplace(name, groups.size());
    if (inserted) {
      groups.emplace_back();
      groups.back().name = name;
    }
    parsed_group[i] = it->second;
    size_t L = name.size();
    if (first_len == SIZE_MAX)
      first_len = L;
    else if (L != first_len)
      multi_len = true;
  }
  // transcript ids of different lengths can be strict substrings of each
  // other; only then does the reference's `contains` grouping differ from
  // exact grouping (vcf_tools.rs:89-92)
  std::unordered_map<size_t, bool> substr_capture;
  if (multi_len) {
    for (auto& [name, gi] : index_of) {
      for (auto& [other, _] : index_of) {
        if (other != name && other.find(name) != string_view::npos) {
          substr_capture[gi] = true;
          break;
        }
      }
    }
  }
  for (size_t i = 0; i < csqs.size(); ++i) {
    size_t gi = parsed_group[i];
    if (gi == SIZE_MAX) continue;
    if (substr_capture.count(gi)) continue;  // filled below
    groups[gi].csqs.push_back(csqs[i].csq);
    if (eager) {
      Mutation m;
      if (parse_mutation(csqs[i].csq, &m, &scratch))
        groups[gi].muts.push_back(std::move(m));
    }
  }
  for (auto& [gi, _] : substr_capture) {
    TranscriptGroup& g = groups[gi];
    for (size_t i = 0; i < csqs.size(); ++i) {
      // the capture quirk matches by TEXT, so even parse-failed entries
      // join the captured group's csq list (reference behavior)
      if (csqs[i].csq.find(g.name) != string_view::npos) {
        g.csqs.push_back(csqs[i].csq);
        if (eager) {
          Mutation m;
          if (parse_mutation(csqs[i].csq, &m, &scratch))
            g.muts.push_back(std::move(m));
        }
      }
    }
  }
  std::sort(groups.begin(), groups.end(),
            [](const TranscriptGroup& a, const TranscriptGroup& b) {
              return a.name < b.name;
            });
  if (eager)
    for (auto& g : groups) drop_replicate(&g);
  return groups;
}

vector<TranscriptGroup> group_by_transcript(const vector<HapCsq>& csqs) {
  return group_assemble(csqs, /*eager=*/true);
}

vector<TranscriptGroup> group_by_transcript_lazy(const vector<HapCsq>& csqs) {
  return group_assemble(csqs, /*eager=*/false);
}

// Build a lazy group's muts + run the dedup/conflict gate -- called only on
// compile-memo misses (one per distinct bundle).
inline void materialize_group(TranscriptGroup* g,
                              vector<string_view>* scratch) {
  g->muts.clear();
  g->muts.reserve(g->csqs.size());
  for (auto c : g->csqs) {
    Mutation m;
    if (parse_mutation(c, &m, scratch)) g->muts.push_back(std::move(m));
  }
  drop_replicate(g);
}

// -------------------------------------------------------- haplotype fusion ---

struct RefTable {
  // name -> (blob offset, length, name index)
  std::unordered_map<string_view, std::tuple<int64_t, int64_t, int64_t>> spans;
};

// One compiled group's task span within a haplotype, tagged with its alt-pool
// segment: [task_begin, task_end) of the haplotype's task arrays, seg is the
// registry segment whose pool offset the exe==1 sources still need added.
struct AltGroupRef {
  int64_t task_begin, task_end;
  int32_t seg;
};

struct HaplotypeOut {
  vector<uint8_t> exe;
  vector<int64_t> src, len, dst;
  string alt;                    // local alt tape (only when pool == nullptr)
  vector<AltGroupRef> alt_groups;  // pool mode: segment refs for the remap
  int64_t res_len = 0;
  vector<std::tuple<int64_t, int64_t, int64_t>> ann;  // (name_idx, start, end)
  // stats block (the -s subsystem; reference: summary.rs:10-117):
  // grouped transcripts per haplotype (post-dedup), their names, and the
  // 22-dim per-type mutation count vector
  vector<string> group_names;
  uint64_t type_counts[NUM_TYPES] = {0};
};

inline uint64_t fnv1a(uint64_t h, string_view s) {
  for (unsigned char c : s) {
    h ^= c;
    h *= 1099511628211ULL;
  }
  h ^= 0x1f;  // separator
  h *= 1099511628211ULL;
  return h;
}

struct MemoEntry {
  string full_key;  // name \x02 csq \x01 csq \x01 ...
  std::shared_ptr<TranscriptProgram> prog;  // null = cached failure
};

struct CompileMemo {
  // sharded by hash so concurrent haplotype workers don't contend on one
  // mutex (a single shared lock measurably serializes the compile stage)
  static constexpr size_t kShards = 64;
  struct Shard {
    std::mutex mu;
    std::unordered_map<uint64_t, vector<MemoEntry>> map;
  };
  Shard shards[kShards];
  // adaptive shutoff: cohorts whose variant bundles don't repeat (low hit
  // rate) pay pure overhead for memoization; disable after a trial window.
  // Breakeven: a sharded lookup costs ~0.5us vs ~1.6us for a fresh
  // transcript compile, so the memo pays its way above roughly a 25% hit
  // rate; shared-variant (1000G-like) cohorts sit far above this, fully
  // random synthetic cohorts below it.
  //
  // Modes: kEnabled runs the full 20k-lookup trial with the 25% shutoff.
  // kSampling (entered when the pool probe saw a near-unique head) exercises
  // the memo on only 1 lookup in 16, so a shared tail behind an
  // unrepresentative head can still re-enable it: after 2048 sampled
  // lookups, a sampled hit rate >= 1/8 (sampling under-counts true sharing
  // because a hit needs its first occurrence sampled too) promotes to
  // kEnabled, anything lower retires to kOff. kOff is terminal and frees the
  // maps. The memo is timing-adaptive and excluded from the bit-parity
  // contract, so none of this affects outputs.
  static constexpr int kEnabled = 0, kSampling = 1, kOff = 2;
  std::atomic<uint64_t> lookups{0};
  std::atomic<uint64_t> hits{0};
  std::atomic<int> mode{kEnabled};
  std::atomic<uint64_t> sample_ticks{0};

  Shard& shard(uint64_t h) { return shards[(h >> 58) & (kShards - 1)]; }

  // Every mode transition is a CAS from the mode the deciding thread
  // OBSERVED: without it, a thread holding stale kSampling counters could
  // read the freshly-zeroed hits right after a concurrent
  // kSampling->kEnabled promotion and permanently turn_off() the memo the
  // promotion just earned.
  void turn_off(int expected) {
    if (!mode.compare_exchange_strong(expected, kOff,
                                      std::memory_order_relaxed))
      return;
    for (auto& sh : shards) {
      std::lock_guard<std::mutex> lock(sh.mu);
      sh.map.clear();
    }
  }

  bool use() {
    int m = mode.load(std::memory_order_relaxed);
    if (m == kOff) return false;
    uint64_t n = lookups.load(std::memory_order_relaxed);
    if (m == kSampling) {
      if (n >= 2048) {
        if (hits.load(std::memory_order_relaxed) * 8 >= n) {
          if (mode.compare_exchange_strong(m, kEnabled,
                                           std::memory_order_relaxed)) {
            // fresh counters, reset ONLY by the promoting thread: the
            // sampled window under-counts the true hit rate and must not
            // feed the kEnabled 25% shutoff below (the kEnabled trial
            // needs n > 20000, so a racing reader of the zeroed counters
            // cannot retrigger a shutoff either)
            lookups.store(0, std::memory_order_relaxed);
            hits.store(0, std::memory_order_relaxed);
          }
          return true;
        }
        turn_off(kSampling);
        return false;
      }
      return (sample_ticks.fetch_add(1, std::memory_order_relaxed) & 15) == 0;
    }
    if (n > 20000 && hits.load(std::memory_order_relaxed) * 4 < n) {
      turn_off(kEnabled);
      return false;
    }
    return true;
  }
};

// Cohort-level alt-pool registry: each distinct (transcript, csq-bundle)
// group owns one pool segment holding its compiled alt bytes. Unlike the
// CompileMemo this has no adaptive (timing-dependent) shutoff: the pool
// layout must be a pure function of the input so the threaded compile
// reproduces the Python oracle's pool bit-for-bit (tests assert tier
// equality on src and pool bytes). Whether a cohort pools AT ALL is decided
// before compile starts by the input-deterministic sharing probe in
// compile_cohort_impl (pool_mode 2). Lookups are cheap -- the group hash is
// shared with the memo and full keys are only built on insert (distinct
// groups).
struct AltPoolRegistry {
  struct Entry {
    string full_key;
    int32_t seg;
  };
  static constexpr size_t kShards = 64;
  struct Shard {
    std::mutex mu;
    std::unordered_map<uint64_t, vector<Entry>> map;
  };
  Shard shards[kShards];
  std::mutex alts_mu;
  std::deque<string> seg_alts;  // segment id -> alt bytes (deque: stable refs)

  Shard& shard(uint64_t h) { return shards[(h >> 58) & (kShards - 1)]; }

  int32_t seg_for(uint64_t h, const TranscriptGroup& g, const string& alt);
};

uint64_t group_hash(const TranscriptGroup& g) {
  uint64_t h = 14695981039346656037ULL;
  h = fnv1a(h, g.name);
  for (auto c : g.csqs) h = fnv1a(h, c);
  return h;
}

// Pointer-keyed first-level group cache. Every carrier of a variant record
// receives csq string_views into the SAME record text, so a group's
// (data pointer, length) tuple sequence identifies its content exactly:
// pointer-key equality implies byte equality (same text spans), and
// pointer-key misses simply fall through to the content-keyed CompileMemo.
// This turns the per-carrier cost of a repeated bundle from two full
// content scans (group_hash + key_matches) into one pointer-tuple hash --
// a pure cache, bit-transparent to outputs. Enabled only in pool mode
// (the shared-bundle regime).
struct GroupPtrMemo {
  struct Entry {
    vector<std::pair<const char*, size_t>> key;  // (name, then csqs)
    std::shared_ptr<TranscriptProgram> prog;     // null = cached failure
    int32_t seg;                                 // alt-pool segment (-1 none)
  };
  static constexpr size_t kShards = 64;
  struct Shard {
    std::mutex mu;
    std::unordered_map<uint64_t, vector<Entry>> map;
  };
  Shard shards[kShards];
  std::atomic<uint64_t> n_hits{0}, n_miss{0};
  Shard& shard(uint64_t h) { return shards[(h >> 58) & (kShards - 1)]; }

  static uint64_t hash(const TranscriptGroup& g) {
    uint64_t h = 14695981039346656037ULL;
    auto mix = [&](uint64_t v) {
      h ^= v;
      h *= 1099511628211ULL;
    };
    mix((uint64_t)(uintptr_t)g.name.data());
    mix((uint64_t)g.name.size());
    for (auto c : g.csqs) {
      mix((uint64_t)(uintptr_t)c.data());
      mix((uint64_t)c.size());
    }
    return h;
  }

  static bool key_eq(const vector<std::pair<const char*, size_t>>& key,
                     const TranscriptGroup& g) {
    if (key.size() != g.csqs.size() + 1) return false;
    if (key[0].first != g.name.data() || key[0].second != g.name.size())
      return false;
    for (size_t i = 0; i < g.csqs.size(); ++i)
      if (key[i + 1].first != g.csqs[i].data() ||
          key[i + 1].second != g.csqs[i].size())
        return false;
    return true;
  }

  static vector<std::pair<const char*, size_t>> make_key(
      const TranscriptGroup& g) {
    vector<std::pair<const char*, size_t>> key;
    key.reserve(g.csqs.size() + 1);
    key.emplace_back(g.name.data(), g.name.size());
    for (auto c : g.csqs) key.emplace_back(c.data(), c.size());
    return key;
  }
};

string group_full_key(const TranscriptGroup& g) {
  string key;
  size_t n = g.name.size() + 1;
  for (auto c : g.csqs) n += c.size() + 1;
  key.reserve(n);
  key.append(g.name);
  key.push_back('\x02');
  for (auto c : g.csqs) {
    key.append(c);
    key.push_back('\x01');
  }
  return key;
}

bool key_matches(const string& full_key, const TranscriptGroup& g) {
  size_t pos = 0;
  auto take = [&](string_view piece, char sep) {
    if (full_key.size() < pos + piece.size() + 1) return false;
    if (string_view(full_key).substr(pos, piece.size()) != piece) return false;
    pos += piece.size();
    if (full_key[pos] != sep) return false;
    ++pos;
    return true;
  };
  if (!take(g.name, '\x02')) return false;
  for (auto c : g.csqs)
    if (!take(c, '\x01')) return false;
  return pos == full_key.size();
}

int32_t AltPoolRegistry::seg_for(uint64_t h, const TranscriptGroup& g,
                                 const string& alt) {
  Shard& sh = shard(h);
  std::lock_guard<std::mutex> lock(sh.mu);
  auto& bucket = sh.map[h];
  for (auto& e : bucket)
    if (key_matches(e.full_key, g)) return e.seg;
  int32_t seg;
  {
    std::lock_guard<std::mutex> l2(alts_mu);
    seg = (int32_t)seg_alts.size();
    seg_alts.push_back(alt);
  }
  bucket.push_back(Entry{group_full_key(g), seg});
  return seg;
}

void compile_haplotype(const vector<HapCsq>& csqs, const RefTable& table,
                       const QcFlags& qc, CompileMemo* memo,
                       AltPoolRegistry* pool, HaplotypeOut* out,
                       vector<string>* warnings, bool collect_stats,
                       vector<TranscriptGroup>* pregrouped = nullptr,
                       GroupPtrMemo* gmemo = nullptr) {
  if (std::getenv("VCF2PROT_NO_MEMO")) {
    memo = nullptr;
    gmemo = nullptr;  // keep the no-memo knob truly unmemoized
  }
  // lazy mode (pool regime, no stats): group with names only; muts + dedup
  // materialize per group only on compile-memo misses
  const bool lazy = gmemo && !collect_stats && !pregrouped;
  vector<string_view> mat_scratch;
  // the pooling probe already grouped the first haplotypes; reuse (consume)
  // its vectors instead of redoing the parse + conflict dedup
  vector<TranscriptGroup> groups =
      pregrouped ? std::move(*pregrouped)
      : lazy ? group_by_transcript_lazy(csqs)
             : group_by_transcript(csqs);
  if (collect_stats) {
    out->group_names.reserve(groups.size());
    for (auto& g : groups) {
      out->group_names.emplace_back(g.name);
      for (auto& m : g.muts) out->type_counts[m.type] += 1;
    }
  }
  if (std::getenv("VCF2PROT_GROUP_ONLY")) return;
  int64_t alt_counter = 0, res_counter = 0;
  for (auto& g : groups) {
    auto it = table.spans.find(g.name);
    std::shared_ptr<TranscriptProgram> prog;
    if (it == table.spans.end()) {
      warnings->push_back("transcript " + string(g.name) +
                          " is not in the reference sequence; skipped");
      continue;
    }
    auto [ref_off, ref_len, name_idx] = it->second;
    int32_t seg = -1;
    bool ptr_hit = false;
    uint64_t ph = 0;
    if (gmemo) {
      // first level: pointer-tuple identity (carriers of a record share
      // csq text spans) -- no content scan at all on a repeat carrier
      ph = GroupPtrMemo::hash(g);
      auto& sh = gmemo->shard(ph);
      std::lock_guard<std::mutex> lock(sh.mu);
      auto git = sh.map.find(ph);
      if (git != sh.map.end())
        for (auto& e : git->second)
          if (GroupPtrMemo::key_eq(e.key, g)) {
            prog = e.prog;
            seg = e.seg;
            ptr_hit = true;
            break;
          }
    }
    if (gmemo) (ptr_hit ? gmemo->n_hits : gmemo->n_miss)
        .fetch_add(1, std::memory_order_relaxed);
    if (ptr_hit) {
      if (memo) {
        // count as a content-memo hit so the adaptive mode's hit-rate
        // statistics stay representative of the cohort's sharing
        memo->lookups.fetch_add(1, std::memory_order_relaxed);
        memo->hits.fetch_add(1, std::memory_order_relaxed);
      }
    } else {
      bool memo_on = memo && memo->use();
      uint64_t h = (memo_on || pool) ? group_hash(g) : 0;
      bool cached = false;
      if (memo_on) {
        auto& sh = memo->shard(h);
        std::lock_guard<std::mutex> lock(sh.mu);
        auto mit = sh.map.find(h);
        if (mit != sh.map.end()) {
          for (auto& entry : mit->second) {
            if (key_matches(entry.full_key, g)) {
              prog = entry.prog;
              cached = true;
              break;
            }
          }
        }
        memo->lookups.fetch_add(1, std::memory_order_relaxed);
        if (cached) memo->hits.fetch_add(1, std::memory_order_relaxed);
      }
      if (!cached) {
        if (lazy) materialize_group(&g, &mat_scratch);
        try {
          prog = std::make_shared<TranscriptProgram>(
              compile_transcript(g.muts, ref_len, qc));
        } catch (const SkipTranscript& e) {
          warnings->push_back("transcript " + string(g.name) + ": " +
                              e.what() + "; skipped");
          prog = nullptr;
        }
        if (memo_on) {
          auto& sh = memo->shard(h);
          std::lock_guard<std::mutex> lock(sh.mu);
          auto& bucket = sh.map[h];
          bool present = false;
          for (auto& entry : bucket)
            if (key_matches(entry.full_key, g)) { present = true; break; }
          if (!present) bucket.push_back(MemoEntry{group_full_key(g), prog});
        }
      }
      if (prog && pool && !prog->alt.empty())
        seg = pool->seg_for(h, g, prog->alt);
      if (gmemo) {
        auto& sh = gmemo->shard(ph);
        std::lock_guard<std::mutex> lock(sh.mu);
        auto& bucket = sh.map[ph];
        bool present = false;
        for (auto& e : bucket)
          if (GroupPtrMemo::key_eq(e.key, g)) { present = true; break; }
        if (!present)
          bucket.push_back(
              GroupPtrMemo::Entry{GroupPtrMemo::make_key(g), prog, seg});
      }
    }
    if (!prog) {
      // cached failure
      continue;
    }
    int64_t task_begin = (int64_t)out->exe.size();
    {
      size_t n = prog->exe_v.size();
      size_t base = out->exe.size();
      out->exe.insert(out->exe.end(), prog->exe_v.begin(), prog->exe_v.end());
      out->len.insert(out->len.end(), prog->len_v.begin(), prog->len_v.end());
      // memcpy-insert then offset in place: resize()'s zero-fill of the new
      // elements was ~8% of the whole compile stage (gprof)
      out->src.insert(out->src.end(), prog->src_v.begin(),
                      prog->src_v.end());
      out->dst.insert(out->dst.end(), prog->dst_v.begin(),
                      prog->dst_v.end());
      const uint8_t* pe = prog->exe_v.data();
      int64_t* os = out->src.data() + base;
      int64_t* od = out->dst.data() + base;
      // pool mode: exe==1 sources stay group-relative here (alt_counter is
      // 0); the cohort driver adds the (deterministic, first-use-ordered)
      // pool offsets in a post-pass once every segment's offset is known
      for (size_t k = 0; k < n; ++k)
        os[k] += pe[k] == 0 ? ref_off : alt_counter;
      for (size_t k = 0; k < n; ++k) od[k] += res_counter;
    }
    out->ann.emplace_back(name_idx, res_counter, res_counter + prog->res_len);
    if (pool) {
      if (seg >= 0)
        out->alt_groups.push_back(AltGroupRef{
            task_begin, (int64_t)out->exe.size(), seg});
    } else {
      out->alt.append(prog->alt);
      alt_counter += (int64_t)prog->alt.size();
    }
    res_counter += prog->res_len;
  }
  out->res_len = res_counter;
}

// ------------------------------------------- compressed input (gzip/BGZF) ---
// .vcf.gz cohort files are BGZF (bgzip): concatenated <=64 KiB gzip members,
// each carrying its compressed size in a 'BC' extra subfield and its
// uncompressed size in ISIZE -- so the block layout is walkable up front and
// the blocks inflate in parallel. Non-BGZF gzip falls back to a serial
// whole-stream inflate. (The reference has no compressed-input support at
// all; its wrappers shell out to `bcftools view` first.)

inline bool looks_gzip(string_view d) {
  return d.size() >= 2 && (uint8_t)d[0] == 0x1f && (uint8_t)d[1] == 0x8b;
}

struct BgzfBlock {
  size_t comp_off, comp_len;  // CDATA span within the compressed file
  size_t out_off, out_len;    // span within the inflated text
};

inline uint32_t le_u16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le_u32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

// Walk the BGZF member chain; false if `comp` is not wall-to-wall BGZF.
bool bgzf_layout(string_view comp, vector<BgzfBlock>* blocks, size_t* total) {
  const uint8_t* d = reinterpret_cast<const uint8_t*>(comp.data());
  size_t n = comp.size(), o = 0, out = 0;
  blocks->clear();
  while (o < n) {
    if (o + 18 > n) return false;
    if (d[o] != 0x1f || d[o + 1] != 0x8b || d[o + 2] != 8 ||
        !(d[o + 3] & 4))
      return false;
    size_t xlen = le_u16(d + o + 10);
    if (o + 12 + xlen > n) return false;
    size_t bsize = 0, e = o + 12;
    const size_t extra_end = o + 12 + xlen;
    while (e + 4 <= extra_end) {
      size_t slen = le_u16(d + e + 2);
      if (d[e] == 66 && d[e + 1] == 67 && slen == 2) {
        if (e + 6 > extra_end) return false;
        bsize = le_u16(d + e + 4) + 1;
        break;
      }
      e += 4 + slen;
    }
    if (bsize == 0 || o + bsize > n || bsize < 12 + xlen + 8) return false;
    size_t cdata_off = o + 12 + xlen;
    size_t cdata_len = bsize - (12 + xlen) - 8;
    size_t isize = le_u32(d + o + bsize - 4);
    if (isize > 0)
      blocks->push_back(BgzfBlock{cdata_off, cdata_len, out, isize});
    out += isize;
    o += bsize;
  }
  *total = out;
  return o == n;
}

bool inflate_bgzf_block(const uint8_t* cdata, size_t clen, char* out,
                        size_t olen, uint32_t want_crc) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;  // raw deflate
  zs.next_in = const_cast<Bytef*>(cdata);
  zs.avail_in = (uInt)clen;
  zs.next_out = reinterpret_cast<Bytef*>(out);
  zs.avail_out = (uInt)olen;
  int rc = inflate(&zs, Z_FINISH);
  bool ok = rc == Z_STREAM_END && zs.total_out == olen;
  inflateEnd(&zs);
  if (!ok) return false;
  return crc32(crc32(0, nullptr, 0), reinterpret_cast<Bytef*>(out),
               (uInt)olen) == want_crc;
}

// Inflate a gzip/BGZF byte span into text. Parallel per-block for BGZF,
// serial whole-stream otherwise (handles concatenated members).
void inflate_gzip_text(string_view comp, string* out, int n_threads) {
  vector<BgzfBlock> blocks;
  size_t total = 0;
  if (bgzf_layout(comp, &blocks, &total)) {
    out->resize(total);
    const uint8_t* d = reinterpret_cast<const uint8_t*>(comp.data());
    std::atomic<size_t> next{0};
    std::atomic<bool> failed{false};
    auto worker = [&]() {
      while (!failed.load(std::memory_order_relaxed)) {
        size_t i = next.fetch_add(1);
        if (i >= blocks.size()) return;
        const BgzfBlock& b = blocks[i];
        uint32_t crc = le_u32(d + b.comp_off + b.comp_len);
        if (!inflate_bgzf_block(d + b.comp_off, b.comp_len,
                                out->data() + b.out_off, b.out_len, crc))
          failed.store(true, std::memory_order_relaxed);
      }
    };
    unsigned hw = n_threads > 0
                      ? (unsigned)n_threads
                      : std::max(1u, std::thread::hardware_concurrency());
    size_t n_workers = std::min<size_t>(std::max(hw, 1u), blocks.size());
    if (n_workers <= 1) {
      worker();
    } else {
      vector<std::thread> ts;
      for (size_t t = 0; t < n_workers; ++t) ts.emplace_back(worker);
      for (auto& t : ts) t.join();
    }
    if (!failed.load()) return;
    // corrupt-looking BGZF: fall through to the strict serial path so the
    // error surfaces with zlib's diagnosis
  }
  out->clear();
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 32) != Z_OK)  // auto gzip/zlib header
    throw FatalError("zlib initialization failed");
  zs.next_in =
      const_cast<Bytef*>(reinterpret_cast<const Bytef*>(comp.data()));
  zs.avail_in = (uInt)comp.size();
  const size_t kChunk = 16 << 20;
  try {
    while (true) {
      size_t used = out->size();
      out->resize(used + kChunk);
      zs.next_out = reinterpret_cast<Bytef*>(out->data() + used);
      zs.avail_out = (uInt)kChunk;
      int rc = inflate(&zs, Z_NO_FLUSH);
      out->resize(used + (kChunk - zs.avail_out));
      if (rc == Z_STREAM_END) {
        if (zs.avail_in == 0) break;
        if (inflateReset(&zs) != Z_OK)  // concatenated gzip members
          throw FatalError("corrupt gzip input: bad member boundary");
        continue;
      }
      if (rc != Z_OK)
        throw FatalError(string("corrupt gzip input: ") +
                         (zs.msg ? zs.msg : "inflate error"));
      if (zs.avail_in == 0 && zs.avail_out != 0)
        throw FatalError("corrupt gzip input: truncated stream");
    }
  } catch (...) {
    inflateEnd(&zs);
    throw;
  }
  inflateEnd(&zs);
}

// Gzip-wrap `data` (for compressed FASTA output; the reference uses flate2
// Compression::best(), personalized_genome.rs:89).
string gzip_compress(string_view data, int level) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, 15 + 16, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK)
    throw FatalError("zlib initialization failed");
  string out;
  out.resize(deflateBound(&zs, (uLong)data.size()) + 18);
  zs.next_in =
      const_cast<Bytef*>(reinterpret_cast<const Bytef*>(data.data()));
  zs.avail_in = (uInt)data.size();
  zs.next_out = reinterpret_cast<Bytef*>(out.data());
  zs.avail_out = (uInt)out.size();
  int rc = deflate(&zs, Z_FINISH);
  bool ok = rc == Z_STREAM_END;
  out.resize(zs.total_out);
  deflateEnd(&zs);
  if (!ok) throw FatalError("gzip compression failed");
  return out;
}

// ------------------------------------------------------------- BCF decode ---
// Native BCF2.2 reader (the binary VCF used by bcftools; spec: samtools
// VCFv4.3/BCF2.2, section 6). The reference cannot read BCF at all -- its
// automation shells out to `bcftools view` (file_automation.py:51-82). Here a
// BCF byte stream (already BGZF-inflated by inflate_gzip_text) decodes
// directly into the same per-(sample,haplotype) csq lists the text scanner
// produces: INFO/BCSQ supplies the consequence string, FORMAT/BCSQ supplies
// the per-sample 2-bit carrier bitmask words (decoded by the same
// decode_words as the text path).

inline bool looks_bcf(string_view d) {
  return d.size() >= 5 && d.substr(0, 3) == "BCF" && (uint8_t)d[3] == 2;
}

struct BcfCursor {
  const uint8_t* p;
  const uint8_t* end;

  size_t left() const { return (size_t)(end - p); }
  void need(size_t n) const {
    if (left() < n) throw FatalError("corrupt BCF: truncated record");
  }
  uint8_t u8() {
    need(1);
    return *p++;
  }
  int32_t i32() {
    need(4);
    int32_t v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  // typed descriptor -> (atomic type, element count)
  void typed(int* type, int64_t* n) {
    uint8_t d = u8();
    *type = d & 0x0F;
    int64_t len = d >> 4;
    if (len == 15) {
      int t2;
      int64_t n2;
      typed(&t2, &n2);
      if (n2 != 1) throw FatalError("corrupt BCF: bad length descriptor");
      len = scalar_int(t2);
    }
    *n = len;
  }
  int64_t scalar_int(int type) {
    switch (type) {
      case 1: {
        need(1);
        int8_t v;
        std::memcpy(&v, p, 1);
        p += 1;
        return v;
      }
      case 2: {
        need(2);
        int16_t v;
        std::memcpy(&v, p, 2);
        p += 2;
        return v;
      }
      case 3:
        return i32();
      default:
        throw FatalError("corrupt BCF: expected integer type");
    }
  }
  static size_t type_size(int type) {
    switch (type) {
      case 0: return 0;
      case 1: return 1;   // int8
      case 2: return 2;   // int16
      case 3: return 4;   // int32
      case 5: return 4;   // float
      case 7: return 1;   // char
      default:
        throw FatalError("corrupt BCF: unknown value type");
    }
  }
  void skip_value(int type, int64_t n) {
    size_t bytes = type_size(type) * (size_t)n;
    need(bytes);
    p += bytes;
  }
  string_view chars(int64_t n) {
    need((size_t)n);
    string_view s(reinterpret_cast<const char*>(p), (size_t)n);
    p += n;
    return s;
  }
};

// Header-text dictionary: FILTER/INFO/FORMAT IDs -> contiguous indices.
// Explicit IDX= fields win; otherwise order of first appearance, with PASS
// implicitly 0 (spec 6.2.1). Returns the index of "BCSQ" (-1 if absent) and
// fills the sample names from the #CHROM line.
int64_t bcf_header_dict(string_view header_text, vector<string>* probands) {
  int64_t bcsq_idx = -1, next_idx = 0;
  std::unordered_map<string, int64_t> dict;
  auto assign = [&](string_view id, int64_t explicit_idx) {
    string key(id);
    auto it = dict.find(key);
    int64_t idx;
    if (explicit_idx >= 0) {
      idx = explicit_idx;
      dict[key] = idx;
      next_idx = std::max(next_idx, idx + 1);
    } else if (it != dict.end()) {
      idx = it->second;
    } else {
      idx = next_idx++;
      dict[key] = idx;
    }
    if (id == "BCSQ") bcsq_idx = idx;
  };
  assign("PASS", 0);
  size_t pos = 0;
  vector<string_view> fields;
  while (pos < header_text.size()) {
    size_t nl = header_text.find('\n', pos);
    string_view line = header_text.substr(
        pos, nl == string_view::npos ? string_view::npos : nl - pos);
    pos = nl == string_view::npos ? header_text.size() : nl + 1;
    if (!line.empty() && line.back() == '\r') line.remove_suffix(1);
    if (line.substr(0, 6) == "#CHROM") {
      while (!line.empty() && line.back() == '\t') line.remove_suffix(1);
      split_into(line, '\t', &fields);
      if (fields.size() < 8)
        throw FatalError("VCF header has fewer than 8 columns");
      for (size_t i = 9; i < fields.size(); ++i)
        probands->emplace_back(fields[i]);
      continue;
    }
    bool is_dict_line = line.substr(0, 9) == "##FILTER=" ||
                        line.substr(0, 7) == "##INFO=" ||
                        line.substr(0, 9) == "##FORMAT=";
    if (!is_dict_line) continue;
    // pull ID=... and optional IDX=... out of the <...> body
    string_view id, idx_s;
    size_t lt = line.find('<');
    string_view body = lt == string_view::npos ? string_view()
                                               : line.substr(lt + 1);
    size_t b = 0;
    while (b < body.size()) {
      size_t comma = body.find(',', b);
      // quoted Description fields may contain commas; skip over quotes
      size_t q = body.find('"', b);
      while (comma != string_view::npos && q != string_view::npos &&
             q < comma) {
        size_t q2 = body.find('"', q + 1);
        if (q2 == string_view::npos) break;
        comma = body.find(',', q2 + 1);
        q = body.find('"', q2 + 1);
      }
      string_view kv = body.substr(
          b, comma == string_view::npos ? string_view::npos : comma - b);
      if (!kv.empty() && kv.back() == '>') kv.remove_suffix(1);
      if (kv.substr(0, 3) == "ID=") id = kv.substr(3);
      if (kv.substr(0, 4) == "IDX=") idx_s = kv.substr(4);
      if (comma == string_view::npos) break;
      b = comma + 1;
    }
    if (id.empty()) continue;
    int64_t explicit_idx = -1;
    if (!idx_s.empty()) {
      int64_t v;
      if (parse_i64(idx_s, &v) && v >= 0) explicit_idx = v;
    }
    if (id == "PASS" && explicit_idx < 0) continue;  // already 0
    assign(id, explicit_idx);
  }
  return bcsq_idx;
}

// sentinel values per integer width (spec 6.3.3)
inline bool int_is_missing(int type, int64_t v) {
  return (type == 1 && v == -128) || (type == 2 && v == -32768) ||
         (type == 3 && v == INT32_MIN);
}
inline bool int_is_end(int type, int64_t v) {
  return (type == 1 && v == -127) || (type == 2 && v == -32767) ||
         (type == 3 && v == INT32_MIN + 1);
}

struct BcfRecord {
  const uint8_t* shared;
  size_t l_shared;
  const uint8_t* indiv;
  size_t l_indiv;
};

// Build the global-sample -> owned-slot map for a sorted, deduplicated
// sample subset (multi-host sharding decodes/compiles only owned samples,
// the in-process analogue of the reference's `bcftools view -S` per-batch
// sharding, automation_scripts/parallization_python.py:196-207). Shrinks
// `probands` to the owned names (in cohort order). Returns the owned count.
size_t apply_sample_subset(const vector<int64_t>& subset, size_t n_samples,
                           vector<string>* probands,
                           vector<int32_t>* owner) {
  owner->assign(n_samples, -1);
  size_t n_owned = 0;
  for (int64_t g : subset) {
    if (g < 0 || g >= (int64_t)n_samples)
      throw FatalError("sample subset index out of range of VCF samples");
    if ((*owner)[(size_t)g] < 0) (*owner)[(size_t)g] = (int32_t)n_owned++;
  }
  vector<string> owned_names(n_owned);
  for (size_t s = 0; s < n_samples; ++s)
    if ((*owner)[s] >= 0)
      owned_names[(size_t)(*owner)[s]] = std::move((*probands)[s]);
  probands->swap(owned_names);
  return n_owned;
}

// Decode a whole BCF stream into per-(sample,hap) csq entry lists; the
// returned string_views point into `data` (the inflated BCF bytes).
// `subset` (sorted global sample indices, or null = all) restricts the
// decode to owned samples: non-owned FORMAT slots are skipped, not decoded.
size_t decode_bcf(string_view data, vector<string>* probands,
                  vector<vector<HapCsq>>* hap_csqs, int n_threads,
                  const vector<int64_t>* subset = nullptr,
                  size_t* mask_decodes = nullptr) {
  BcfCursor top{reinterpret_cast<const uint8_t*>(data.data()),
                reinterpret_cast<const uint8_t*>(data.data()) + data.size()};
  top.need(9);
  top.p += 5;  // "BCF\2\x02" (any minor version)
  uint32_t l_text = (uint32_t)top.i32();
  top.need(l_text);
  string_view header_text(reinterpret_cast<const char*>(top.p), l_text);
  top.p += l_text;
  int64_t bcsq_idx = bcf_header_dict(header_text, probands);
  size_t n_samples = probands->size();
  if (n_samples == 0) throw FatalError("no samples found in VCF header");
  vector<int32_t> owner;
  size_t n_owned = n_samples;
  if (subset)
    n_owned = apply_sample_subset(*subset, n_samples, probands, &owner);
  if (bcsq_idx < 0)
    throw FatalError("could not extract any records from the provided file");

  // phase 1: record spans (O(1) skip per record via l_shared/l_indiv)
  vector<BcfRecord> records;
  while (top.left() > 0) {
    uint32_t l_shared = (uint32_t)top.i32();
    uint32_t l_indiv = (uint32_t)top.i32();
    top.need((size_t)l_shared + l_indiv);
    records.push_back(
        BcfRecord{top.p, l_shared, top.p + l_shared, l_indiv});
    top.p += (size_t)l_shared + l_indiv;
  }

  // phase 2: parallel per-record decode, merged in record order
  hap_csqs->assign(2 * n_owned, {});
  unsigned hw = n_threads > 0
                    ? (unsigned)n_threads
                    : std::max(1u, std::thread::hardware_concurrency());
  size_t n_chunks = std::min<size_t>(
      std::max<size_t>(1, records.size() / 256), std::max(1u, hw) * 4);
  n_chunks = std::max<size_t>(n_chunks, 1);
  size_t chunk_sz = (records.size() + n_chunks - 1) / n_chunks;
  vector<vector<vector<HapCsq>>> chunk_out(
      n_chunks, vector<vector<HapCsq>>(2 * n_owned));
  vector<size_t> chunk_counts(n_chunks, 0);
  vector<size_t> chunk_decodes(n_chunks, 0);
  std::exception_ptr dec_error;
  std::mutex dec_mu;
  std::atomic<size_t> next_chunk{0};

  auto decode_one = [&](const BcfRecord& rec,
                        vector<vector<HapCsq>>& out,
                        vector<string_view>& entries, vector<int>& supported,
                        vector<string_view>& names,
                        vector<uint8_t>& ok_flags,
                        vector<string_view>& psplit,
                        vector<uint32_t>& words, MaskIndices& mi,
                        size_t& ndec) -> bool {
    BcfCursor sh{rec.shared, rec.shared + rec.l_shared};
    sh.need(24);
    sh.p += 16;  // CHROM, POS, rlen, QUAL
    int32_t n_allele_info = sh.i32();
    int32_t n_fmt_sample = sh.i32();
    int64_t n_info = n_allele_info & 0xFFFF;
    int64_t n_allele = (uint32_t)n_allele_info >> 16;
    int64_t n_fmt = (uint32_t)n_fmt_sample >> 24;
    int64_t rec_samples = n_fmt_sample & 0xFFFFFF;
    if (rec_samples != (int64_t)n_samples)
      throw FatalError(
          "truncated VCF record: fewer sample columns than samples");
    int type;
    int64_t n;
    sh.typed(&type, &n);  // ID
    sh.skip_value(type, n);
    for (int64_t a = 0; a < n_allele; ++a) {  // REF + ALTs
      sh.typed(&type, &n);
      sh.skip_value(type, n);
    }
    sh.typed(&type, &n);  // FILTER
    sh.skip_value(type, n);
    string_view csq;
    bool have_csq = false;
    for (int64_t i = 0; i < n_info; ++i) {
      int ktype;
      int64_t kn;
      sh.typed(&ktype, &kn);
      if (kn != 1) throw FatalError("corrupt BCF: bad INFO key");
      int64_t key = sh.scalar_int(ktype);
      sh.typed(&type, &n);
      if (key == bcsq_idx && type == 7) {
        csq = sh.chars(n);
        have_csq = true;
      } else {
        sh.skip_value(type, n);
      }
    }
    if (!have_csq) return false;
    // supported filter: same 6-pipe + known-type rule as the text path
    bool any_supported = false;
    {
      size_t start = 0;
      while (start <= csq.size()) {
        size_t comma = csq.find(',', start);
        string_view entry = csq.substr(
            start,
            comma == string_view::npos ? string_view::npos : comma - start);
        int pipes = (int)std::count(entry.begin(), entry.end(), '|');
        if (pipes == 6 && lookup_type(field_before(entry, '|')) >= 0) {
          any_supported = true;
          break;
        }
        if (comma == string_view::npos) break;
        start = comma + 1;
      }
    }
    if (!any_supported) return false;

    // indiv block: find FORMAT/BCSQ, decode each sample's bitmask words
    BcfCursor iv{rec.indiv, rec.indiv + rec.l_indiv};
    bool entries_split = false;
    for (int64_t f = 0; f < n_fmt; ++f) {
      int ktype;
      int64_t kn;
      iv.typed(&ktype, &kn);
      if (kn != 1) throw FatalError("corrupt BCF: bad FORMAT key");
      int64_t key = iv.scalar_int(ktype);
      int vtype;
      int64_t vn;
      iv.typed(&vtype, &vn);
      if (key != bcsq_idx) {
        iv.skip_value(vtype, vn * (int64_t)n_samples);
        continue;
      }
      if (vtype == 0) return true;  // MISSING for all samples
      for (size_t s = 0; s < n_samples; ++s) {
        int32_t slot = subset ? owner[s] : (int32_t)s;
        if (slot < 0) {
          // not owned by this shard: skip the sample's value slots unscanned
          iv.skip_value(vtype, vn);
          continue;
        }
        words.clear();
        bool negative = false;
        for (int64_t j = 0; j < vn; ++j) {
          int64_t v = iv.scalar_int(vtype);
          if (int_is_end(vtype, v) || int_is_missing(vtype, v)) {
            // consume the rest of this sample's slots
            for (int64_t k = j + 1; k < vn; ++k) iv.scalar_int(vtype);
            break;
          }
          if (v < 0) negative = true;
          words.push_back((uint32_t)(int32_t)v);
        }
        if (negative)
          throw FatalError("An invalid bit mask was encountered: BCF record");
        mi.hap1.clear();
        mi.hap2.clear();
        mi.carrier = false;
        ++ndec;
        decode_words(words, &mi);
        if (!mi.carrier) continue;
        if (!entries_split) {
          split_into(csq, ',', &entries);
          supported.assign(entries.size(), 0);
          names.assign(entries.size(), string_view());
          ok_flags.assign(entries.size(), 0);
          for (size_t e = 0; e < entries.size(); ++e) {
            supported[e] = lookup_type(field_before(entries[e], '|')) >= 0;
            if (supported[e]) {
              Mutation pm;
              if (parse_mutation(entries[e], &pm, &psplit)) {
                names[e] = pm.transcript;
                ok_flags[e] = 1;
              }
            }
          }
          entries_split = true;
        }
        for (int e : mi.hap1)
          if ((size_t)e < entries.size() && supported[e])
            out[2 * (size_t)slot].push_back(
                  HapCsq{entries[e], names[e], ok_flags[e] != 0});
          else if ((size_t)e >= entries.size())
            throw FatalError("bitmask index out of range of BCSQ entries");
        for (int e : mi.hap2)
          if ((size_t)e < entries.size() && supported[e])
            out[2 * (size_t)slot + 1].push_back(
                HapCsq{entries[e], names[e], ok_flags[e] != 0});
          else if ((size_t)e >= entries.size())
            throw FatalError("bitmask index out of range of BCSQ entries");
      }
      return true;
    }
    return true;  // supported INFO but no FORMAT/BCSQ: no carriers
  };

  auto dec_worker = [&]() {
    vector<string_view> entries;
    vector<int> supported;
    vector<string_view> names;
    vector<uint8_t> ok_flags;
    vector<string_view> psplit;
    vector<uint32_t> words;
    MaskIndices mi;
    while (true) {
      size_t c = next_chunk.fetch_add(1);
      if (c >= n_chunks) return;
      try {
        size_t lo = c * chunk_sz;
        size_t hi = std::min(records.size(), lo + chunk_sz);
        size_t count = 0;
        size_t ndec = 0;
        for (size_t r = lo; r < hi; ++r)
          if (decode_one(records[r], chunk_out[c], entries, supported,
                         names, ok_flags, psplit, words, mi, ndec))
            ++count;
        chunk_counts[c] = count;
        chunk_decodes[c] = ndec;
      } catch (...) {
        std::lock_guard<std::mutex> lock(dec_mu);
        if (!dec_error) dec_error = std::current_exception();
        return;
      }
    }
  };
  size_t n_workers = std::min<size_t>(std::max(hw, 1u), n_chunks);
  if (n_workers <= 1) {
    dec_worker();
  } else {
    vector<std::thread> ts;
    for (size_t t = 0; t < n_workers; ++t) ts.emplace_back(dec_worker);
    for (auto& t : ts) t.join();
  }
  if (dec_error) std::rethrow_exception(dec_error);
  size_t n_supported = 0;
  for (size_t c = 0; c < n_chunks; ++c) n_supported += chunk_counts[c];
  for (size_t h = 0; h < 2 * n_owned; ++h) {
    size_t total = 0;
    for (auto& co : chunk_out) total += co[h].size();
    (*hap_csqs)[h].reserve(total);
    for (auto& co : chunk_out)
      (*hap_csqs)[h].insert((*hap_csqs)[h].end(), co[h].begin(),
                            co[h].end());
  }
  return n_supported;
}

// --------------------------------------------------------- cohort driver ---

struct CohortResult {
  vector<string> probands;
  vector<HaplotypeOut> haps;  // 2 per proband: hap1, hap2
  vector<string> warnings;
  // pool mode: the cohort-level shared alt tape (first-use order); every
  // haplotype's exe==1 sources are absolute offsets into it
  string pool;
  bool pooled = false;
  // owned-carrier mask decodes performed (deterministic work counter: a
  // sample shard must DECODE only its own columns, and tests assert the
  // counter partitions across shards instead of racing wall clocks)
  size_t mask_decodes = 0;
};

// Jump to the Nth tab-separated field without splitting the whole line
// (record lines carry 9 + n_samples columns; the filter needs only INFO).
bool nth_field(string_view line, int n, string_view* out) {
  size_t pos = 0;
  for (int i = 0; i < n; ++i) {
    size_t tab = line.find('\t', pos);
    if (tab == string_view::npos) return false;
    pos = tab + 1;
  }
  size_t end = line.find('\t', pos);
  *out = line.substr(
      pos, end == string_view::npos ? string_view::npos : end - pos);
  return true;
}

bool info_has_supported_csq(string_view info) {
  // find "BCSQ=" sub-field
  size_t pos = 0;
  string_view bcsq;
  bool found = false;
  while (pos <= info.size()) {
    size_t semi = info.find(';', pos);
    string_view sub = info.substr(
        pos, semi == string_view::npos ? string_view::npos : semi - pos);
    if (sub.substr(0, 5) == "BCSQ=") {
      // reference takes split('=')[1]: text up to the next '=' if any
      string_view rest = sub.substr(5);
      size_t eq = rest.find('=');
      bcsq = eq == string_view::npos ? rest : rest.substr(0, eq);
      found = true;
      break;
    }
    if (semi == string_view::npos) break;
    pos = semi + 1;
  }
  if (!found) return false;
  size_t start = 0;
  while (start <= bcsq.size()) {
    size_t comma = bcsq.find(',', start);
    string_view entry = bcsq.substr(
        start, comma == string_view::npos ? string_view::npos : comma - start);
    // is_supported_csq: exactly 6 pipes + known type
    int pipes = (int)std::count(entry.begin(), entry.end(), '|');
    if (pipes == 6 && lookup_type(field_before(entry, '|')) >= 0) return true;
    if (comma == string_view::npos) break;
    start = comma + 1;
  }
  return false;
}

bool record_is_supported(string_view line) {
  string_view info;
  return nth_field(line, 7, &info) && info_has_supported_csq(info);
}

string_view bcsq_payload(string_view info) {
  // INFO -> everything after the first "BCSQ=" (vcf_ds.rs:67-86)
  size_t p = info.find("BCSQ=");
  return info.substr(p + 5);
}

// pool_mode: 0 = local alt tapes, 1 = cohort-level shared alt pool,
// 2 = auto (deterministic sharing probe over the first haplotypes; see
// cohort_should_pool in compiler/haplotype.py -- the Python tier applies the
// IDENTICAL rule so the tiers stay array-identical).
// subset: sorted global sample indices owned by this shard (null = all).
// Decode and compile touch ONLY owned samples, so multi-host runs split the
// dominant parse+compile stage instead of duplicating it per host.
CohortResult compile_cohort_impl(string_view vcf_text,
                                 const vector<string>& ref_names,
                                 const vector<int64_t>& ref_offsets,
                                 const QcFlags& qc, int n_threads,
                                 bool collect_stats, int pool_mode = 0,
                                 const vector<int64_t>* subset = nullptr) {
  const bool timing = std::getenv("VCF2PROT_NATIVE_TIMING") != nullptr;
  auto tick = std::chrono::steady_clock::now();
  auto lap = [&](const char* what) {
    if (!timing) return;
    auto now = std::chrono::steady_clock::now();
    fprintf(stderr, "[native] %s: %.3fs\n", what,
            std::chrono::duration<double>(now - tick).count());
    tick = now;
  };
  CohortResult result;
  RefTable table;
  for (size_t i = 0; i < ref_names.size(); ++i)
    table.spans.emplace(
        ref_names[i],
        std::make_tuple(ref_offsets[i], ref_offsets[i + 1] - ref_offsets[i],
                        (int64_t)i));

  vector<vector<HapCsq>> hap_csqs;
  size_t n_samples = 0;
  size_t n_supported = 0;
  if (looks_bcf(vcf_text)) {
    // binary VCF: decode records directly (no text transcode)
    n_supported =
        decode_bcf(vcf_text, &result.probands, &hap_csqs, n_threads, subset,
                   &result.mask_decodes);
    n_samples = result.probands.size();
    if (n_supported == 0)
      throw FatalError("could not extract any records from the provided file");
    lap("BCF decode");
  } else {
  // --- header scan (serial, touches only the leading '#' lines): sample
  // names from the '#CHROM' row + the byte offset where records begin
  size_t body_start = 0;
  {
    string_view text(vcf_text);
    size_t pos = 0;
    vector<string_view> fields;
    while (pos < text.size()) {
      size_t nl = text.find('\n', pos);
      string_view line =
          text.substr(pos, nl == string_view::npos ? string_view::npos
                                                   : nl - pos);
      size_t next = nl == string_view::npos ? text.size() : nl + 1;
      if (!line.empty() && line.back() == '\r') line.remove_suffix(1);
      if (line.empty()) {
        pos = next;
        continue;
      }
      if (line[0] != '#') break;  // first record line: body starts here
      if (line.substr(0, 6) == "#CHROM") {
        while (!line.empty() && line.back() == '\t') line.remove_suffix(1);
        split_into(line, '\t', &fields);
        if (fields.size() < 8)
          throw FatalError("VCF header has fewer than 8 columns");
        for (size_t i = 9; i < fields.size(); ++i)
          result.probands.emplace_back(fields[i]);
        n_samples = result.probands.size();
      }
      pos = next;
    }
    body_start = pos;
  }
  if (n_samples == 0) throw FatalError("no samples found in VCF header");
  // sharded run: decode only owned FORMAT columns; the column walk can stop
  // at the last owned column (the truncation check then covers only the
  // walked prefix -- acceptable, each shard validates the columns it reads)
  vector<int32_t> owner;
  size_t n_owned = n_samples;
  size_t n_cols_needed = n_samples;
  if (subset) {
    n_owned = apply_sample_subset(*subset, n_samples, &result.probands,
                                  &owner);
    n_cols_needed = 0;
    for (size_t s = 0; s < n_samples; ++s)
      if (owner[s] >= 0) n_cols_needed = s + 1;
  }
  // leading non-owned columns are tab-skipped at popcount speed (contiguous
  // shards then walk only their own column range); the truncation check
  // covers columns up to the last owned one -- each shard validates the
  // columns it reads
  size_t col_skip = 0;
  if (subset)
    while (col_skip < n_samples && owner[col_skip] < 0) ++col_skip;
  lap("header scan");

  // --- fused record filter + per-sample decode, threaded over newline-
  // aligned byte ranges of the record body; chunk outputs merge in byte
  // order so per-haplotype mutation order matches a serial pass
  hap_csqs.assign(2 * n_owned, {});
  {
    string_view body = string_view(vcf_text).substr(body_start);
    unsigned dec_threads =
        n_threads > 0 ? (unsigned)n_threads
                      : std::max(1u, std::thread::hardware_concurrency());
    // >=32 MB per chunk; an atomic work queue over the chunks keeps the
    // workers balanced even when record density varies across the file
    size_t n_chunks =
        body.empty() ? 1
                     : std::min<size_t>(
                           64, std::max<size_t>(std::max<size_t>(dec_threads, 1),
                                                body.size() >> 25));
    size_t step = (body.size() + n_chunks - 1) / n_chunks;
    // chunk boundary rule: chunk c starts at the first line start at/after
    // c*step (chunk 0 at 0); a line spanning a raw boundary belongs to the
    // earlier chunk. Both ends computed with the same rule => no gap/overlap.
    auto chunk_begin = [&](size_t c) -> size_t {
      if (c == 0) return 0;
      size_t r = c * step;
      if (r >= body.size()) return body.size();
      size_t nl = body.find('\n', r);
      return nl == string_view::npos ? body.size() : nl + 1;
    };
    vector<vector<vector<HapCsq>>> chunk_out(
        n_chunks, vector<vector<HapCsq>>(2 * n_owned));
    vector<size_t> chunk_counts(n_chunks, 0);
    vector<size_t> chunk_decodes(n_chunks, 0);
    std::exception_ptr dec_error;
    std::mutex dec_mu;
    std::atomic<size_t> next_chunk{0};
    auto decode_chunk = [&](size_t c) {
      vector<string_view> entries;
      vector<int> supported;
      vector<string_view> names;
      vector<uint8_t> ok_flags;
      vector<string_view> psplit;
      vector<CarrierCol> carriers;
      MaskIndices mi;
      auto& out = chunk_out[c];
      size_t pos = chunk_begin(c);
      const size_t end = chunk_begin(c + 1);
      size_t count = 0;
      size_t ndec = 0;
      while (pos < end) {
        size_t nl = body.find('\n', pos);
        string_view line = body.substr(
            pos, (nl == string_view::npos ? body.size() : nl) - pos);
        pos = nl == string_view::npos ? body.size() : nl + 1;
        if (!line.empty() && line.back() == '\r') line.remove_suffix(1);
        if (line.empty() || line[0] == '#') continue;
        // filter: INFO (field 7) must carry a supported BCSQ consequence
        string_view info;
        if (!nth_field(line, 7, &info)) continue;
        if (!info_has_supported_csq(info)) continue;
        ++count;
        // decode: continue the forward walk after INFO, then SIMD-scan the
        // sample region for carrier columns
        string_view csq = bcsq_payload(info);
        size_t p = (size_t)(info.data() - line.data()) + info.size();
        if (p >= line.size() || line[p] != '\t')
          throw FatalError(
              "truncated VCF record: fewer sample columns than samples");
        size_t col_start = line.find('\t', p + 1);  // skip FORMAT
        if (col_start == string_view::npos)
          throw FatalError(
              "truncated VCF record: fewer sample columns than samples");
        ++col_start;
        string_view region = line.substr(col_start);
        if (walk_sample_columns(region, n_cols_needed, &carriers, col_skip)
            < n_cols_needed)
          throw FatalError(
              "truncated VCF record: fewer sample columns than samples");
        bool entries_split = false;
        for (const CarrierCol& cc : carriers) {
          int32_t slot = subset ? owner[cc.sample] : (int32_t)cc.sample;
          if (slot < 0) continue;  // not owned: skip the mask decode entirely
          ++ndec;
          decode_mask(region.substr(cc.mask_off, cc.mask_len), &mi);
          if (!mi.carrier) continue;
          if (!entries_split) {
            split_into(csq, ',', &entries);
            supported.assign(entries.size(), 0);
            // resolve each entry's transcript name ONCE PER RECORD (the
            // full mutation parse); per-carrier pushes are then pure
            // pointer copies -- see HapCsq
            names.assign(entries.size(), string_view());
            ok_flags.assign(entries.size(), 0);
            for (size_t e = 0; e < entries.size(); ++e) {
              supported[e] = lookup_type(field_before(entries[e], '|')) >= 0;
              if (supported[e]) {
                Mutation pm;
                if (parse_mutation(entries[e], &pm, &psplit)) {
                  names[e] = pm.transcript;
                  ok_flags[e] = 1;
                }
              }
            }
            entries_split = true;
          }
          for (int e : mi.hap1)
            if ((size_t)e < entries.size() && supported[e])
              out[2 * (size_t)slot].push_back(
                  HapCsq{entries[e], names[e], ok_flags[e] != 0});
            else if ((size_t)e >= entries.size())
              throw FatalError("bitmask index out of range of BCSQ entries");
          for (int e : mi.hap2)
            if ((size_t)e < entries.size() && supported[e])
              out[2 * (size_t)slot + 1].push_back(
                  HapCsq{entries[e], names[e], ok_flags[e] != 0});
            else if ((size_t)e >= entries.size())
              throw FatalError("bitmask index out of range of BCSQ entries");
        }
      }
      chunk_counts[c] = count;
      chunk_decodes[c] = ndec;
    };
    auto dec_worker = [&]() {
      while (true) {
        size_t c = next_chunk.fetch_add(1);
        if (c >= n_chunks) return;
        try {
          decode_chunk(c);
        } catch (...) {
          std::lock_guard<std::mutex> lock(dec_mu);
          if (!dec_error) dec_error = std::current_exception();
          return;
        }
      }
    };
    size_t n_workers = std::min<size_t>(std::max(dec_threads, 1u), n_chunks);
    if (n_workers <= 1) {
      dec_worker();
    } else {
      vector<std::thread> ts;
      for (size_t t = 0; t < n_workers; ++t) ts.emplace_back(dec_worker);
      for (auto& t : ts) t.join();
    }
    if (dec_error) std::rethrow_exception(dec_error);
    for (size_t c = 0; c < n_chunks; ++c) n_supported += chunk_counts[c];
    for (size_t c = 0; c < n_chunks; ++c)
      result.mask_decodes += chunk_decodes[c];
    if (n_supported == 0)
      throw FatalError("could not extract any records from the provided file");
    lap("record filter + sample decode");
    for (size_t h = 0; h < 2 * n_owned; ++h) {
      size_t total = 0;
      for (auto& co : chunk_out) total += co[h].size();
      hap_csqs[h].reserve(total);
      for (auto& co : chunk_out)
        hap_csqs[h].insert(hap_csqs[h].end(), co[h].begin(), co[h].end());
    }
  }
  }  // text / BCF branch

  // --- pooling decision (auto mode): the shared alt pool pays for itself
  // only when (transcript, csq-bundle) groups repeat across haplotypes --
  // 1000G-like shared-variant cohorts -- and is pure per-group overhead on
  // cohorts whose bundles are (near-)unique. Probe the first
  // kPoolProbeHaplotypes haplotypes in cohort scan order and count distinct
  // group identities: a pure function of the input, so the decision is
  // deterministic and reproducible by the serial Python tier (which applies
  // the same rule in compiler/haplotype.py cohort_should_pool).
  bool probe_declined = false;
  // the probe's grouping work (full parse + conflict dedup of the first 32
  // haplotypes) is handed to the compile workers below instead of redone
  vector<vector<TranscriptGroup>> probe_groups;
  if (pool_mode == 2) {
    constexpr size_t kPoolProbeHaplotypes = 32;
    size_t probe_n = std::min<size_t>(kPoolProbeHaplotypes, hap_csqs.size());
    size_t total_groups = 0;
    probe_groups.resize(probe_n);
    {
      // grouping is the probe's cost; spread it over the compile threads
      // (the vectors are handed to the compile workers below, so this work
      // is reused, not redone). The distinct-count stays serial: hashing 32
      // haplotypes' keys is cheap and order never affects the outcome.
      unsigned phw = n_threads > 0
                         ? (unsigned)n_threads
                         : std::max(1u, std::thread::hardware_concurrency());
      std::atomic<size_t> pnext{0};
      auto pworker = [&]() {
        while (true) {
          size_t i = pnext.fetch_add(1);
          if (i >= probe_n) return;
          probe_groups[i] = group_by_transcript(hap_csqs[i]);
        }
      };
      if (phw <= 1 || probe_n <= 1) {
        pworker();
      } else {
        vector<std::thread> threads;
        for (unsigned t = 0; t < std::min<size_t>(phw, probe_n); ++t)
          threads.emplace_back(pworker);
        for (auto& t : threads) t.join();
      }
    }
    // exact distinct-identity count without building key strings: bucket by
    // the (allocation-free) group hash, confirm with direct field equality.
    // Same count as the Python tier's set of (name, csqs) tuples.
    auto groups_equal = [](const TranscriptGroup& a, const TranscriptGroup& b) {
      if (a.name != b.name || a.csqs.size() != b.csqs.size()) return false;
      for (size_t k = 0; k < a.csqs.size(); ++k)
        if (a.csqs[k] != b.csqs[k]) return false;
      return true;
    };
    std::unordered_map<uint64_t, vector<const TranscriptGroup*>> seen;
    size_t n_distinct = 0;
    for (size_t i = 0; i < probe_n; ++i)
      for (auto& g : probe_groups[i]) {
        ++total_groups;
        auto& bucket = seen[group_hash(g)];
        bool dup = false;
        for (const TranscriptGroup* o : bucket)
          if (groups_equal(*o, g)) {
            dup = true;
            break;
          }
        if (!dup) {
          bucket.push_back(&g);
          ++n_distinct;
        }
      }
    // pool iff >=10% of the probe's groups are repeats
    pool_mode =
        (total_groups > 0 && n_distinct * 10 <= total_groups * 9) ? 1 : 0;
    probe_declined = pool_mode == 0;
    lap("pool probe");
  }
  const bool use_pool = pool_mode == 1;

  // --- per-haplotype compile (thread pool over haplotypes)
  const size_t n_haps = hap_csqs.size();
  result.haps.resize(n_haps);
  CompileMemo memo;
  // a probe that found (near-)unique bundles predicts a cold memo: drop to
  // the cheap 1-in-16 sampling mode instead of the full trial window, so a
  // cohort whose head is unrepresentative (unique head, shared tail) can
  // still re-enable the memo once the sampled hit rate turns out high
  if (probe_declined) memo.mode.store(CompileMemo::kSampling);
  AltPoolRegistry pool_registry;
  AltPoolRegistry* pool = use_pool ? &pool_registry : nullptr;
  // the pointer-keyed group cache pays only where variant bundles repeat
  // across carriers -- exactly the shared-bundle regime the probe detected
  GroupPtrMemo group_ptr_memo;
  GroupPtrMemo* gmemo = use_pool ? &group_ptr_memo : nullptr;
  vector<vector<string>> warn_parts(n_haps);
  std::exception_ptr first_error;
  std::mutex err_mu;
  unsigned hw = n_threads > 0 ? (unsigned)n_threads
                              : std::max(1u, std::thread::hardware_concurrency());
  std::atomic<size_t> next{0};
  auto worker = [&]() {
    while (true) {
      size_t i = next.fetch_add(1);
      if (i >= result.haps.size()) return;
      try {
        compile_haplotype(hap_csqs[i], table, qc, &memo, pool,
                          &result.haps[i], &warn_parts[i], collect_stats,
                          i < probe_groups.size() ? &probe_groups[i]
                                                  : nullptr,
                          gmemo);
      } catch (...) {
        std::lock_guard<std::mutex> lock(err_mu);
        if (!first_error) first_error = std::current_exception();
        return;
      }
    }
  };
  if (hw <= 1 || result.haps.size() <= 1) {
    worker();
  } else {
    vector<std::thread> threads;
    for (unsigned t = 0; t < std::min<size_t>(hw, result.haps.size()); ++t)
      threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  if (first_error) std::rethrow_exception(first_error);
  lap("haplotype compile");
  if (gmemo && std::getenv("VCF2PROT_NATIVE_TIMING"))
    fprintf(stderr, "[native] group ptr-memo: %llu hits / %llu misses\n",
            (unsigned long long)gmemo->n_hits.load(),
            (unsigned long long)gmemo->n_miss.load());
  if (use_pool) {
    // Deterministic pool layout: registry segment ids are thread-ordered,
    // so re-assign offsets by FIRST USE in cohort scan order (haplotypes in
    // order, groups in transcript order) -- exactly the serial Python
    // oracle's AltPool order -- then rebase each group's exe==1 sources.
    result.pooled = true;
    vector<int64_t> seg_off(pool_registry.seg_alts.size(), -1);
    size_t total = 0;
    for (auto& s : pool_registry.seg_alts) total += s.size();
    result.pool.reserve(total);
    for (auto& h : result.haps)
      for (auto& gr : h.alt_groups)
        if (seg_off[gr.seg] < 0) {
          seg_off[gr.seg] = (int64_t)result.pool.size();
          result.pool.append(pool_registry.seg_alts[gr.seg]);
        }
    std::atomic<size_t> next_fix{0};
    auto fixer = [&]() {
      while (true) {
        size_t i = next_fix.fetch_add(1);
        if (i >= result.haps.size()) return;
        HaplotypeOut& h = result.haps[i];
        for (auto& gr : h.alt_groups) {
          int64_t off = seg_off[gr.seg];
          for (int64_t t = gr.task_begin; t < gr.task_end; ++t)
            if (h.exe[(size_t)t] == 1) h.src[(size_t)t] += off;
        }
        h.alt_groups.clear();
        h.alt_groups.shrink_to_fit();
      }
    };
    if (hw <= 1 || result.haps.size() <= 1) {
      fixer();
    } else {
      vector<std::thread> threads;
      for (unsigned t = 0; t < std::min<size_t>(hw, result.haps.size()); ++t)
        threads.emplace_back(fixer);
      for (auto& t : threads) t.join();
    }
    lap("alt-pool remap");
  }
  for (auto& w : warn_parts)
    result.warnings.insert(result.warnings.end(), w.begin(), w.end());
  return result;
}

#ifndef VCF2PROT_NO_PYTHON
// ------------------------------------------------------- CPython binding ---

PyObject* bytes_from(const void* data, size_t n) {
  return PyBytes_FromStringAndSize(static_cast<const char*>(data),
                                   (Py_ssize_t)n);
}

PyObject* py_compile_cohort(PyObject*, PyObject* args, PyObject* kwargs) {
  static const char* kwlist[] = {"vcf_path",   "ref_names", "ref_offsets",
                                 "qc_flags",   "n_threads", "collect_stats",
                                 "ann_arrays", "alt_pool",  "sample_subset",
                                 nullptr};
  const char* vcf_path = nullptr;
  PyObject* ref_names_obj = nullptr;
  PyObject* ref_offsets_obj = nullptr;  // bytes of int64[n+1]
  int qc_flags = 7;
  int n_threads = 0;
  int collect_stats = 0;
  int ann_arrays = 0;  // emit annotations as packed arrays, not tuple lists
  int alt_pool = 0;    // 0 off, 1 shared alt pool, 2 auto-probe (1/2 return a
                       // 4-tuple whose pool element is None when not pooled)
  PyObject* subset_obj = nullptr;  // bytes of int64 global sample indices
                                   // owned by this shard (None = all samples)
  if (!PyArg_ParseTupleAndKeywords(
          args, kwargs, "sOO|iiiiiO", const_cast<char**>(kwlist), &vcf_path,
          &ref_names_obj, &ref_offsets_obj, &qc_flags, &n_threads,
          &collect_stats, &ann_arrays, &alt_pool, &subset_obj))
    return nullptr;
  vector<int64_t> subset;
  bool have_subset = subset_obj && subset_obj != Py_None;
  if (have_subset) {
    char* buf;
    Py_ssize_t sz;
    if (PyBytes_AsStringAndSize(subset_obj, &buf, &sz) < 0) return nullptr;
    if (sz % (Py_ssize_t)sizeof(int64_t) != 0) {
      PyErr_SetString(PyExc_ValueError,
                      "sample_subset must be bytes of int64");
      return nullptr;
    }
    subset.resize((size_t)sz / sizeof(int64_t));
    std::memcpy(subset.data(), buf, (size_t)sz);
  }

  vector<string> ref_names;
  PyObject* names_fast =
      PySequence_Fast(ref_names_obj, "ref_names must be a sequence");
  if (!names_fast) return nullptr;
  {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(names_fast);
    ref_names.reserve((size_t)n);
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* item = PySequence_Fast_GET_ITEM(names_fast, i);
      Py_ssize_t sz;
      const char* s = PyUnicode_AsUTF8AndSize(item, &sz);
      if (!s) {
        Py_DECREF(names_fast);
        return nullptr;
      }
      ref_names.emplace_back(s, (size_t)sz);
    }
  }
  vector<int64_t> ref_offsets;
  {
    char* buf;
    Py_ssize_t sz;
    if (PyBytes_AsStringAndSize(ref_offsets_obj, &buf, &sz) < 0) return nullptr;
    if ((size_t)sz != (ref_names.size() + 1) * sizeof(int64_t)) {
      PyErr_SetString(PyExc_ValueError, "ref_offsets size mismatch");
      return nullptr;
    }
    ref_offsets.resize(ref_names.size() + 1);
    std::memcpy(ref_offsets.data(), buf, (size_t)sz);
  }

  QcFlags qc;
  qc.inspect_ins_gen = qc_flags & 1;
  qc.inspect_txp = qc_flags & 2;
  qc.panic_on_err = qc_flags & 4;

  // memory-map the VCF and compile without the GIL; mmap keeps working-set
  // memory O(mutations) instead of O(file) for pod-scale cohort files
  CohortResult result;
  string err_msg;
  bool failed = false;
  Py_BEGIN_ALLOW_THREADS {
    void* mapped = MAP_FAILED;
    size_t map_len = 0;
    int fd = -1;
    try {
      fd = open(vcf_path, O_RDONLY);
      if (fd < 0) throw FatalError(string("could not open ") + vcf_path);
      struct stat st;
      if (fstat(fd, &st) != 0 || st.st_size < 0)
        throw FatalError(string("could not stat ") + vcf_path);
      map_len = (size_t)st.st_size;
      string_view text;
      string fallback;
      if (map_len > 0) {
        mapped = mmap(nullptr, map_len, PROT_READ, MAP_PRIVATE, fd, 0);
        if (mapped != MAP_FAILED) {
          madvise(mapped, map_len, MADV_SEQUENTIAL);
          text = string_view(static_cast<const char*>(mapped), map_len);
        } else {
          std::ifstream in(vcf_path, std::ios::binary);
          fallback.assign(std::istreambuf_iterator<char>(in),
                          std::istreambuf_iterator<char>());
          text = fallback;
        }
        if (looks_gzip(text)) {
          // gzip/BGZF input: inflate (parallel for BGZF) and release the map
          string inflated;
          inflate_gzip_text(text, &inflated, n_threads);
          fallback.swap(inflated);
          text = fallback;
          if (mapped != MAP_FAILED) {
            munmap(mapped, map_len);
            mapped = MAP_FAILED;
          }
        }
      }
      result = compile_cohort_impl(text, ref_names, ref_offsets, qc, n_threads,
                                   collect_stats != 0, alt_pool,
                                   have_subset ? &subset : nullptr);
    } catch (const std::exception& e) {
      err_msg = e.what();
      failed = true;
    }
    if (mapped != MAP_FAILED && map_len > 0) munmap(mapped, map_len);
    if (fd >= 0) close(fd);
  }
  Py_END_ALLOW_THREADS;
  if (failed) {
    Py_DECREF(names_fast);
    PyErr_SetString(PyExc_RuntimeError, err_msg.c_str());
    return nullptr;
  }

  PyObject* probands = PyList_New((Py_ssize_t)result.probands.size());
  for (size_t i = 0; i < result.probands.size(); ++i)
    PyList_SET_ITEM(probands, (Py_ssize_t)i,
                    PyUnicode_FromStringAndSize(result.probands[i].data(),
                                                (Py_ssize_t)result.probands[i].size()));
  PyObject* haps = PyList_New((Py_ssize_t)result.haps.size());
  for (size_t i = 0; i < result.haps.size(); ++i) {
    HaplotypeOut& h = result.haps[i];
    // annotations: packed (i32 name-index, i64 start, i64 end) arrays by
    // default avoid materializing millions of Python tuples at pod scale;
    // the tuple-list form remains available for compatibility
    PyObject* ann;
    if (ann_arrays) {
      size_t m = h.ann.size();
      vector<int32_t> idx(m);
      vector<int64_t> st_v(m), en_v(m);
      for (size_t a = 0; a < m; ++a) {
        idx[a] = (int32_t)std::get<0>(h.ann[a]);
        st_v[a] = std::get<1>(h.ann[a]);
        en_v[a] = std::get<2>(h.ann[a]);
      }
      ann = Py_BuildValue("(NNN)",
                          bytes_from(idx.data(), m * sizeof(int32_t)),
                          bytes_from(st_v.data(), m * sizeof(int64_t)),
                          bytes_from(en_v.data(), m * sizeof(int64_t)));
    } else {
      ann = PyList_New((Py_ssize_t)h.ann.size());
      for (size_t a = 0; a < h.ann.size(); ++a) {
        auto [ni, st, en] = h.ann[a];
        PyObject* name_obj =
            PySequence_Fast_GET_ITEM(names_fast, (Py_ssize_t)ni);
        PyList_SET_ITEM(ann, (Py_ssize_t)a,
                        Py_BuildValue("(OLL)", name_obj, (long long)st,
                                      (long long)en));
      }
    }
    PyObject* stats;
    if (collect_stats) {
      PyObject* gnames = PyList_New((Py_ssize_t)h.group_names.size());
      for (size_t g = 0; g < h.group_names.size(); ++g)
        PyList_SET_ITEM(
            gnames, (Py_ssize_t)g,
            PyUnicode_FromStringAndSize(h.group_names[g].data(),
                                        (Py_ssize_t)h.group_names[g].size()));
      PyObject* counts = PyList_New(NUM_TYPES);
      for (int t = 0; t < NUM_TYPES; ++t)
        PyList_SET_ITEM(counts, t,
                        PyLong_FromUnsignedLongLong(h.type_counts[t]));
      stats = Py_BuildValue("(NN)", gnames, counts);
    } else {
      stats = Py_None;
      Py_INCREF(stats);
    }
    PyObject* tup = Py_BuildValue(
        "(NNNNNLNN)",
        bytes_from(h.exe.data(), h.exe.size()),
        bytes_from(h.src.data(), h.src.size() * sizeof(int64_t)),
        bytes_from(h.len.data(), h.len.size() * sizeof(int64_t)),
        bytes_from(h.dst.data(), h.dst.size() * sizeof(int64_t)),
        bytes_from(h.alt.data(), h.alt.size()),
        (long long)h.res_len, ann, stats);
    PyList_SET_ITEM(haps, (Py_ssize_t)i, tup);
  }
  PyObject* warnings = PyList_New((Py_ssize_t)result.warnings.size());
  for (size_t i = 0; i < result.warnings.size(); ++i)
    PyList_SET_ITEM(warnings, (Py_ssize_t)i,
                    PyUnicode_FromStringAndSize(result.warnings[i].data(),
                                                (Py_ssize_t)result.warnings[i].size()));
  Py_DECREF(names_fast);
  // deterministic work counters (last element in every shape): sample
  // shards assert these PARTITION across hosts instead of racing clocks
  PyObject* counters = Py_BuildValue(
      "{s:n,s:n}", "mask_decodes", (Py_ssize_t)result.mask_decodes,
      "haplotypes", (Py_ssize_t)result.haps.size());
  if (alt_pool) {
    // 4th element: the shared pool bytes, or None when auto mode decided
    // against pooling (haplotypes then carry local alt tapes)
    PyObject* pool_obj;
    if (result.pooled) {
      pool_obj = bytes_from(result.pool.data(), result.pool.size());
    } else {
      pool_obj = Py_None;
      Py_INCREF(pool_obj);
    }
    return Py_BuildValue("(NNNNN)", probands, haps, warnings, pool_obj,
                         counters);
  }
  return Py_BuildValue("(NNNN)", probands, haps, warnings, counters);
}

// Execute one haplotype's task program into a fresh byte tape: the native
// memcpy-speed counterpart of the Python serial oracle (task.rs:38-50).
PyObject* py_execute_tasks(PyObject*, PyObject* args) {
  Py_buffer exe_b, src_b, len_b, dst_b, alt_b, blob_b;
  long long res_len;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*L", &exe_b, &src_b, &len_b, &dst_b,
                        &alt_b, &blob_b, &res_len))
    return nullptr;
  PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)res_len);
  if (!out) return nullptr;
  char* res = PyBytes_AS_STRING(out);
  bool ok = true;
  Py_BEGIN_ALLOW_THREADS {
    std::memset(res, '.', (size_t)res_len);
    const uint8_t* exe = static_cast<const uint8_t*>(exe_b.buf);
    const int64_t* src = static_cast<const int64_t*>(src_b.buf);
    const int64_t* len = static_cast<const int64_t*>(len_b.buf);
    const int64_t* dst = static_cast<const int64_t*>(dst_b.buf);
    const char* alt = static_cast<const char*>(alt_b.buf);
    const char* blob = static_cast<const char*>(blob_b.buf);
    int64_t alt_n = (int64_t)alt_b.len;
    int64_t blob_n = (int64_t)blob_b.len;
    size_t n = (size_t)(exe_b.len);
    for (size_t i = 0; i < n; ++i) {
      if (len[i] <= 0) continue;
      // overflow-safe: a <= limit - b form, never a + b (can wrap)
      if (dst[i] < 0 || len[i] > res_len || dst[i] > res_len - len[i]) {
        ok = false;
        break;
      }
      if (exe[i] == 0) {
        if (src[i] < 0 || len[i] > blob_n || src[i] > blob_n - len[i]) {
          ok = false;
          break;
        }
        std::memcpy(res + dst[i], blob + src[i], (size_t)len[i]);
      } else if (exe[i] == 1) {
        if (src[i] < 0 || len[i] > alt_n || src[i] > alt_n - len[i]) {
          ok = false;
          break;
        }
        std::memcpy(res + dst[i], alt + src[i], (size_t)len[i]);
      }
    }
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&exe_b);
  PyBuffer_Release(&src_b);
  PyBuffer_Release(&len_b);
  PyBuffer_Release(&dst_b);
  PyBuffer_Release(&alt_b);
  PyBuffer_Release(&blob_b);
  if (!ok) {
    Py_DECREF(out);
    PyErr_SetString(PyExc_IndexError, "task program out of bounds");
    return nullptr;
  }
  return out;
}

// Neoantigen candidate collection for one executed haplotype: all k-mer
// windows that (a) lie entirely inside one annotation span and (b) overlap
// at least one mutated byte (alt-sourced, non-'.' filler). Exact port of
// the numpy oracle (downstream/report._host_candidates /
// downstream/peptides.py); the cohort accumulator uses this as its fast
// path and tests pin array equality. Returns (windows_bytes, starts_i64).
PyObject* py_collect_candidates(PyObject*, PyObject* args) {
  Py_buffer exe_b, src_b, len_b, dst_b, alt_b, ann_s_b, ann_e_b, tape_b;
  long long res_len, kk;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*y*y*LL", &exe_b, &src_b, &len_b,
                        &dst_b, &alt_b, &ann_s_b, &ann_e_b, &tape_b,
                        &res_len, &kk))
    return nullptr;
  string win_out;
  vector<int64_t> starts_out;
  bool ok = true;
  // cross-buffer shape validation BEFORE any indexing: every task array
  // must carry exe_b.len entries, annotation starts/ends must pair up
  if (res_len < 0 || kk <= 0 || (int64_t)tape_b.len < res_len ||
      src_b.len != (Py_ssize_t)exe_b.len * 8 ||
      len_b.len != (Py_ssize_t)exe_b.len * 8 ||
      dst_b.len != (Py_ssize_t)exe_b.len * 8 ||
      ann_s_b.len != ann_e_b.len || ann_s_b.len % 8 != 0)
    ok = false;
  Py_BEGIN_ALLOW_THREADS try {
    const uint8_t* exe = static_cast<const uint8_t*>(exe_b.buf);
    const int64_t* tsrc = static_cast<const int64_t*>(src_b.buf);
    const int64_t* tlen = static_cast<const int64_t*>(len_b.buf);
    const int64_t* tdst = static_cast<const int64_t*>(dst_b.buf);
    const char* alt = static_cast<const char*>(alt_b.buf);
    const int64_t* ann_s = static_cast<const int64_t*>(ann_s_b.buf);
    const int64_t* ann_e = static_cast<const int64_t*>(ann_e_b.buf);
    const char* tape = static_cast<const char*>(tape_b.buf);
    const size_t n_tasks = (size_t)exe_b.len;
    const size_t n_ann = (size_t)(ann_s_b.len / 8);
    const int64_t k = (int64_t)kk;
    const int64_t alt_n = (int64_t)alt_b.len;
    if (ok) {
      // mutated-byte prefix sum (alt-sourced, non-'.' bytes)
      vector<int64_t> cum((size_t)res_len + 1, 0);
      vector<uint8_t> is_alt((size_t)res_len, 0);
      for (size_t t = 0; t < n_tasks && ok; ++t) {
        if (exe[t] != 1 || tlen[t] <= 0) continue;
        // overflow-safe form: dst <= res_len - len (all operands checked
        // non-negative first), never dst + len which can wrap
        if (tdst[t] < 0 || tlen[t] > res_len ||
            tdst[t] > res_len - tlen[t] || tsrc[t] < 0 ||
            tlen[t] > alt_n || tsrc[t] > alt_n - tlen[t]) {
          ok = false;
          break;
        }
        const char* a = alt + tsrc[t];
        uint8_t* m = is_alt.data() + tdst[t];
        for (int64_t o = 0; o < tlen[t]; ++o) m[o] = a[o] != '.';
      }
      if (ok) {
        for (int64_t j = 0; j < res_len; ++j)
          cum[(size_t)j + 1] = cum[(size_t)j] + is_alt[(size_t)j];  // NOLINT
        // spans must be sorted and disjoint (the compiler's tiling
        // invariant): overlapping spans would emit duplicate windows where
        // the numpy oracle's boolean start mask emits each start once, so
        // reject them instead of silently diverging
        for (size_t a = 0; a < n_ann && ok; ++a) {
          if (ann_s[a] > ann_e[a] || (a > 0 && ann_s[a] < ann_e[a - 1]))
            ok = false;
        }
        // per-span candidate scan: starts in [s, e-k] with >=1 mutated
        // byte in [j, j+k)
        for (size_t a = 0; ok && a < n_ann; ++a) {
          int64_t s = ann_s[a], e = ann_e[a];
          if (s < 0 || e > res_len || e - s < k) continue;
          for (int64_t j = s; j + k <= e; ++j) {
            if (cum[(size_t)(j + k)] - cum[(size_t)j] > 0) {
              win_out.append(tape + j, (size_t)k);
              starts_out.push_back(j);
            }
          }
        }
      }
    }
  } catch (...) {
    // exception barrier: std::bad_alloc etc. must not unwind through the
    // CPython frame with the GIL released
    ok = false;
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&exe_b);
  PyBuffer_Release(&src_b);
  PyBuffer_Release(&len_b);
  PyBuffer_Release(&dst_b);
  PyBuffer_Release(&alt_b);
  PyBuffer_Release(&ann_s_b);
  PyBuffer_Release(&ann_e_b);
  PyBuffer_Release(&tape_b);
  if (!ok) {
    PyErr_SetString(PyExc_IndexError,
                    "collect_candidates: program out of bounds");
    return nullptr;
  }
  PyObject* wins = PyBytes_FromStringAndSize(win_out.data(),
                                             (Py_ssize_t)win_out.size());
  PyObject* starts = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(starts_out.data()),
      (Py_ssize_t)(starts_out.size() * 8));
  if (!wins || !starts) {
    Py_XDECREF(wins);
    Py_XDECREF(starts);
    return nullptr;
  }
  PyObject* tup = PyTuple_Pack(2, wins, starts);
  Py_DECREF(wins);
  Py_DECREF(starts);
  return tup;
}

// Write one sample's altered-only FASTA: two haplotype tapes + their
// (header, start, end) annotation lists -> ">name_1\nseq\n" records
// (reference: personalized_genome.rs:102-115), formatted and written
// entirely in C.
PyObject* py_write_fasta(PyObject*, PyObject* args) {
  const char* path;
  Py_buffer tape1, tape2;
  PyObject* ann1;
  PyObject* ann2;
  int gzip_level = 0;  // 0 = plain text; >0 = gzip (reference uses best=9)
  if (!PyArg_ParseTuple(args, "sy*Oy*O|i", &path, &tape1, &ann1, &tape2,
                        &ann2, &gzip_level))
    return nullptr;
  string buf;
  buf.reserve((size_t)(tape1.len + tape2.len) + 4096);
  bool ok = true;
  const char* suffixes[2] = {"_1", "_2"};
  Py_buffer* tapes[2] = {&tape1, &tape2};
  PyObject* anns[2] = {ann1, ann2};
  for (int h = 0; h < 2 && ok; ++h) {
    PyObject* seq = PySequence_Fast(anns[h], "annotations must be a sequence");
    if (!seq) { ok = false; break; }
    const char* tape = static_cast<const char*>(tapes[h]->buf);
    Py_ssize_t tape_len = tapes[h]->len;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
      PyObject* name_obj = PyTuple_GET_ITEM(item, 0);
      long long st = PyLong_AsLongLong(PyTuple_GET_ITEM(item, 1));
      long long en = PyLong_AsLongLong(PyTuple_GET_ITEM(item, 2));
      Py_ssize_t name_len;
      const char* name = PyUnicode_AsUTF8AndSize(name_obj, &name_len);
      if (!name || st < 0 || en < st || en > tape_len) {
        if (!name) PyErr_Clear();
        PyErr_SetString(PyExc_ValueError, "bad annotation span");
        ok = false;
        break;
      }
      buf.push_back('>');
      buf.append(name, (size_t)name_len);
      buf.append(suffixes[h]);
      buf.push_back('\n');
      buf.append(tape + st, (size_t)(en - st));
      buf.push_back('\n');
    }
    Py_DECREF(seq);
  }
  bool write_ok = true;
  if (ok) {
    Py_BEGIN_ALLOW_THREADS {
      try {
        if (gzip_level > 0) {
          string gz = gzip_compress(buf, gzip_level);
          buf.swap(gz);
        }
        FILE* f = fopen(path, "wb");
        if (!f) {
          write_ok = false;
        } else {
          if (fwrite(buf.data(), 1, buf.size(), f) != buf.size())
            write_ok = false;
          if (fclose(f) != 0) write_ok = false;
        }
      } catch (const std::exception&) {
        write_ok = false;
      }
    }
    Py_END_ALLOW_THREADS;
  }
  PyBuffer_Release(&tape1);
  PyBuffer_Release(&tape2);
  if (!ok) return nullptr;
  if (!write_ok) {
    PyErr_Format(PyExc_OSError, "could not write %s", path);
    return nullptr;
  }
  Py_RETURN_NONE;
}

// Array-annotation twin of py_write_fasta: spans arrive as packed
// (i32 name-index, i64 start, i64 end) arrays plus a shared name blob
// (concatenated names + i64 offsets), so no per-record Python objects exist
// anywhere between compile and file write.
PyObject* py_write_fasta_arrays(PyObject*, PyObject* args) {
  const char* path;
  Py_buffer tape1, idx1, st1, en1, tape2, idx2, st2, en2, names, offs;
  int gzip_level = 0;
  if (!PyArg_ParseTuple(args, "sy*y*y*y*y*y*y*y*y*y*|i", &path, &tape1, &idx1,
                        &st1, &en1, &tape2, &idx2, &st2, &en2, &names, &offs,
                        &gzip_level))
    return nullptr;
  Py_buffer* tapes[2] = {&tape1, &tape2};
  Py_buffer* idxs[2] = {&idx1, &idx2};
  Py_buffer* sts[2] = {&st1, &st2};
  Py_buffer* ens[2] = {&en1, &en2};
  const char* suffixes[2] = {"_1", "_2"};
  const char* name_blob = static_cast<const char*>(names.buf);
  const int64_t* name_off = static_cast<const int64_t*>(offs.buf);
  size_t n_names = (size_t)(offs.len / sizeof(int64_t));  // n+1 offsets
  bool ok = true, write_ok = true;
  Py_BEGIN_ALLOW_THREADS {
    string buf;
    buf.reserve((size_t)(tape1.len + tape2.len) + 4096);
    for (int h = 0; h < 2 && ok; ++h) {
      const char* tape = static_cast<const char*>(tapes[h]->buf);
      int64_t tape_len = (int64_t)tapes[h]->len;
      const int32_t* idx = static_cast<const int32_t*>(idxs[h]->buf);
      const int64_t* st = static_cast<const int64_t*>(sts[h]->buf);
      const int64_t* en = static_cast<const int64_t*>(ens[h]->buf);
      size_t m = (size_t)(idxs[h]->len / sizeof(int32_t));
      if (sts[h]->len != (Py_ssize_t)(m * sizeof(int64_t)) ||
          ens[h]->len != (Py_ssize_t)(m * sizeof(int64_t))) {
        ok = false;
        break;
      }
      for (size_t i = 0; i < m; ++i) {
        int64_t ni = idx[i];
        if (ni < 0 || (size_t)ni + 1 >= n_names || st[i] < 0 ||
            en[i] < st[i] || en[i] > tape_len) {
          ok = false;
          break;
        }
        buf.push_back('>');
        buf.append(name_blob + name_off[ni],
                   (size_t)(name_off[ni + 1] - name_off[ni]));
        buf.append(suffixes[h]);
        buf.push_back('\n');
        buf.append(tape + st[i], (size_t)(en[i] - st[i]));
        buf.push_back('\n');
      }
    }
    if (ok) {
      try {
        if (gzip_level > 0) {
          string gz = gzip_compress(buf, gzip_level);
          buf.swap(gz);
        }
        FILE* f = fopen(path, "wb");
        if (!f) {
          write_ok = false;
        } else {
          if (fwrite(buf.data(), 1, buf.size(), f) != buf.size())
            write_ok = false;
          if (fclose(f) != 0) write_ok = false;
        }
      } catch (const std::exception&) {
        write_ok = false;
      }
    }
  }
  Py_END_ALLOW_THREADS;
  for (Py_buffer* b :
       {&tape1, &idx1, &st1, &en1, &tape2, &idx2, &st2, &en2, &names, &offs})
    PyBuffer_Release(b);
  if (!ok) {
    PyErr_SetString(PyExc_ValueError, "bad annotation span");
    return nullptr;
  }
  if (!write_ok) {
    PyErr_Format(PyExc_OSError, "could not write %s", path);
    return nullptr;
  }
  Py_RETURN_NONE;
}

// Word-aligned executor program for one packed chunk: the native twin of
// runtime/device_engine.build_aligned_program's numpy oracle (tests pin array
// equality). One O(tasks + boundary-bytes) pass -- no word-length
// temporaries, so at north-star scale this costs ~30 ms where the numpy
// form's 33M-word cover/cumsum/nonzero cost ~2 s per chunk (the host-side
// overhead that ate the aligned kernel's device win in round 5).
// Inputs: int32 dst + int32 src_biased (the engines gate the aligned path
// on int32 packs), total_res, combined_len.
// Returns (wstart i32[n], wbase i32[n], bpos i32[b], bsrc i32[b]) bytes.
PyObject* py_build_aligned_program(PyObject*, PyObject* args) {
  Py_buffer dst_b, src_b;
  long long total_res, combined_len;
  if (!PyArg_ParseTuple(args, "y*y*LL", &dst_b, &src_b, &total_res,
                        &combined_len))
    return nullptr;
  bool ok = dst_b.len == src_b.len && dst_b.len % 4 == 0 && total_res >= 0;
  const size_t n = ok ? (size_t)(dst_b.len / 4) : 0;
  vector<int32_t> wstart(n), wbase(n), bpos, bsrc;
  Py_BEGIN_ALLOW_THREADS try {
    if (ok) {
      const int32_t* d = static_cast<const int32_t*>(dst_b.buf);
      const int32_t* s = static_cast<const int32_t*>(src_b.buf);
      const int64_t nw = (total_res + 3) / 4;
      size_t t = 0;  // covering-task pointer (bpos ascends; dst sorted)
      auto emit = [&](int64_t w0, int64_t w1) {
        for (int64_t w = w0; w < w1; ++w) {
          for (int64_t b = 0; b < 4; ++b) {
            int64_t pos = 4 * w + b;
            if (pos >= total_res) return;
            while (t + 1 < n && (int64_t)d[t + 1] <= pos) ++t;
            bpos.push_back((int32_t)pos);
            bsrc.push_back((int32_t)((int64_t)s[t] + pos - (int64_t)d[t]));
          }
        }
      };
      int64_t w = 0;  // next word not yet covered by a uniform interval
      for (size_t i = 0; i < n; ++i) {
        int64_t di = d[i];
        int64_t end = i + 1 < n ? (int64_t)d[i + 1] : total_res;
        wstart[i] = (int32_t)((di + 3) >> 2);
        wbase[i] = (int32_t)((int64_t)s[i] - di);
        int64_t wf = (di + 3) >> 2;
        int64_t wl = end >> 2;
        bool safe = (int64_t)s[i] + (end - di) <= combined_len - 8;
        if (wl > wf && safe) {
          if (wf > w) emit(w, wf < nw ? wf : nw);
          if (wl > w) w = wl;
        }
      }
      if (nw > w) emit(w, nw);
    }
  } catch (...) {
    ok = false;
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&dst_b);
  PyBuffer_Release(&src_b);
  if (!ok) {
    PyErr_SetString(PyExc_ValueError,
                    "build_aligned_program: malformed int32 task arrays");
    return nullptr;
  }
  PyObject* ws = bytes_from(wstart.data(), wstart.size() * 4);
  PyObject* wb = bytes_from(wbase.data(), wbase.size() * 4);
  PyObject* bp = bytes_from(bpos.data(), bpos.size() * 4);
  PyObject* bs = bytes_from(bsrc.data(), bsrc.size() * 4);
  if (!ws || !wb || !bp || !bs) {
    Py_XDECREF(ws);
    Py_XDECREF(wb);
    Py_XDECREF(bp);
    Py_XDECREF(bs);
    return nullptr;
  }
  PyObject* tup = PyTuple_Pack(4, ws, wb, bp, bs);
  Py_DECREF(ws);
  Py_DECREF(wb);
  Py_DECREF(bp);
  Py_DECREF(bs);
  return tup;
}

PyMethodDef methods[] = {
    {"compile_cohort", (PyCFunction)py_compile_cohort,
     METH_VARARGS | METH_KEYWORDS,
     "Parse a bcftools/csq VCF and compile per-haplotype task programs."},
    {"build_aligned_program", py_build_aligned_program, METH_VARARGS,
     "Word-aligned executor program (middle words + boundary bytes)."},
    {"collect_candidates", py_collect_candidates, METH_VARARGS,
     "neoantigen candidate windows of one executed haplotype"},
    {"execute_tasks", py_execute_tasks, METH_VARARGS,
     "Execute a haplotype task program into a byte tape."},
    {"write_fasta", py_write_fasta, METH_VARARGS,
     "Write one sample's altered-only personalized-proteome FASTA."},
    {"write_fasta_arrays", py_write_fasta_arrays, METH_VARARGS,
     "write_fasta with packed (name-idx, start, end) annotation arrays."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "vcf2prot_native",
                      "native frontend + compiler", -1, methods};

#endif  // VCF2PROT_NO_PYTHON

}  // namespace

#ifndef VCF2PROT_NO_PYTHON
PyMODINIT_FUNC PyInit_vcf2prot_native(void) { return PyModule_Create(&module); }
#endif  // VCF2PROT_NO_PYTHON
