// The op semantics of K48 stage_program (csrc/stage_program.cu), written
// once as host-and-device functions: nvcc builds them into the kernel, and
// g++ builds the same header into a host harness (csrc/stage_host.cpp) that
// the CPU tests hold bit for bit against the plain interpreter of
// ops/program.py.
//
// A stage program is a flat list of instructions of seven int64 words,
// (op, type, dst, a, b, c, imm), over typed registers. A register is one
// 64-bit value word and one validity byte:
//   - BOOL and the integer types hold the value sign-extended to 64 bits,
//     always wrapped to the type's width;
//   - FLOAT32 holds the float's value as a double (exact), FLOAT64 the
//     double's bits.
// Every op reads its operands before it writes its destination, so a
// destination may reuse an operand's register. A NULL result has data 0.
//
// Semantics that C++ and torch would otherwise disagree on:
//   - integer add / sub / mul / negate / abs wrap: they run in uint64 and
//     wrap to the width (signed overflow is undefined in C++);
//   - integer division and remainder by 0 give NULL; INT64_MIN div -1
//     wraps; x % -1 is 0 (the C remainder traps there);
//   - a float -> integral cast truncates, NaN gives 0 and the value
//     saturates at the type's range (ops/cast.py);
//   - shift amounts are taken mod the width (Java); >>> is logical at the
//     width;
//   - the build adds -fmad=false (nvcc) and -ffp-contract=off (g++): each
//     product and sum rounds on its own, as torch's eager ops do.
//
// Type and op codes must match ops/program.py (T_* and OPS).
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define SRT_HD __host__ __device__ __forceinline__
#else
#define SRT_HD inline
#endif

namespace srt_stage {

enum Type : int {
  T_BOOL = 0, T_I8 = 1, T_I16 = 2, T_I32 = 3, T_I64 = 4, T_F32 = 5,
  T_F64 = 6, T_VALID = 7  // T_VALID: a column whose validity alone loads
};

enum Op : int {
  LOAD = 0, STORE, KEEP, CONST, NULLC, CAST,
  ADD, SUB, MUL, DIV, REM, PMOD, IDIV, FDIV, FMOD, NEG, ABS, SIGNUM,
  EQ, LT, LE, GT, GE, EQNS, AND, OR, NOT, ANYEQ, INFIN,
  ISNULL, ISNOTNULL, ISNAN, NANVL, COALESCE, CNTNN, SELECT,
  BAND, BOR, BXOR, BNOT, SHL, SHR, USHR,
  CIVIL, NORMNAN, FLOOR, CEIL,
  SIN, COS, TAN, ASIN, ACOS, ATAN, SINH, COSH, TANH, ASINH, ACOSH, ATANH,
  SQRT, CBRT, EXP, EXPM1, LOG, LOG1P, LOG2, LOG10, RINT, DEGREES, RADIANS,
  COT, POW, ATAN2, LOGB,
  N_OPS
};

constexpr int kWords = 7;  // words an instruction

SRT_HD double as_f(uint64_t w) {
#ifdef __CUDA_ARCH__
  return __longlong_as_double((long long)w);
#else
  double d;
  std::memcpy(&d, &w, 8);
  return d;
#endif
}

SRT_HD uint64_t from_f(double d) {
#ifdef __CUDA_ARCH__
  return (uint64_t)__double_as_longlong(d);
#else
  uint64_t w;
  std::memcpy(&w, &d, 8);
  return w;
#endif
}

SRT_HD bool is_float(int t) { return t == T_F32 || t == T_F64; }

// an integer wrapped to the width of type t, sign-extended
SRT_HD int64_t wrap(uint64_t u, int t) {
  switch (t) {
    case T_BOOL: return (int64_t)(u & 1u);
    case T_I8: return (int64_t)(int8_t)(uint8_t)u;
    case T_I16: return (int64_t)(int16_t)(uint16_t)u;
    case T_I32: return (int64_t)(int32_t)(uint32_t)u;
    default: return (int64_t)u;
  }
}

// a double rounded to type t's precision (F32 rounds to nearest float)
SRT_HD double fround(double d, int t) {
  return t == T_F32 ? (double)(float)d : d;
}

SRT_HD int64_t imin(int t) {
  switch (t) {
    case T_BOOL: return 0;
    case T_I8: return -128;
    case T_I16: return -32768;
    case T_I32: return -2147483647LL - 1;
    default: return (-9223372036854775807LL - 1);
  }
}

SRT_HD int64_t imax(int t) {
  switch (t) {
    case T_BOOL: return 1;
    case T_I8: return 127;
    case T_I16: return 32767;
    case T_I32: return 2147483647LL;
    default: return 9223372036854775807LL;
  }
}

SRT_HD int width(int t) {
  return t == T_I64 ? 64 : t == T_I32 ? 32 : t == T_I16 ? 16 : 8;
}

// the numeric conversion of word w from type `from` to type `to`:
// to BOOL is != 0 (NaN is true); float -> integral truncates, NaN -> 0,
// saturating; integral -> integral wraps; -> float rounds to nearest
SRT_HD uint64_t convert(uint64_t w, int from, int to) {
  if (from == to) return w;
  if (to == T_BOOL) {
    if (is_float(from)) return as_f(w) != 0.0 ? 1u : 0u;
    return (int64_t)w != 0 ? 1u : 0u;
  }
  if (is_float(from)) {
    const double d = as_f(w);
    if (is_float(to)) return from_f(fround(d, to));
    if (d != d) return 0;
    const double t = trunc(d);
    if (from == T_F32) {
      // compare at the source's precision, as the cast does
      const float tf = (float)t;
      if (tf >= (float)imax(to)) return (uint64_t)imax(to);
      if (tf <= (float)imin(to)) return (uint64_t)imin(to);
    } else {
      if (t >= (double)imax(to)) return (uint64_t)imax(to);
      if (t <= (double)imin(to)) return (uint64_t)imin(to);
    }
    return (uint64_t)(int64_t)t;
  }
  const int64_t i = (int64_t)w;
  if (to == T_F32) return from_f((double)(float)i);
  if (to == T_F64) return from_f((double)i);
  return (uint64_t)wrap((uint64_t)i, to);
}

SRT_HD int64_t floor_div64(int64_t a, int64_t b) {
  if (b == -1) return (int64_t)(0 - (uint64_t)a);
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

SRT_HD int64_t floor_mod64(int64_t a, int64_t b) {
  if (b == -1) return 0;
  int64_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// truncated remainder, the divisor not 0 (x % -1 == 0)
SRT_HD int64_t trunc_mod64(int64_t a, int64_t b) {
  return b == -1 ? 0 : a % b;
}

// epoch days -> (year, month, day), the proleptic Gregorian calendar
SRT_HD void civil(int64_t days, int64_t* y, int64_t* m, int64_t* d) {
  const int64_t z = days + 719468;
  const int64_t era = floor_div64(z, 146097);
  const int64_t doe = z - era * 146097;
  const int64_t yoe = floor_div64(doe - floor_div64(doe, 1460) +
                                      floor_div64(doe, 36524) -
                                      floor_div64(doe, 146096),
                                  365);
  const int64_t doy =
      doe - (365 * yoe + floor_div64(yoe, 4) - floor_div64(yoe, 100));
  const int64_t mp = floor_div64(5 * doy + 2, 153);
  *d = doy - floor_div64(153 * mp + 2, 5) + 1;
  *m = mp < 10 ? mp + 3 : mp - 9;
  *y = yoe + era * 400 + (*m <= 2 ? 1 : 0);
}

SRT_HD int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
  y -= m <= 2 ? 1 : 0;
  const int64_t era = floor_div64(y, 400);
  const int64_t yoe = y - era * 400;
  const int64_t mp = m > 2 ? m - 3 : m + 9;
  const int64_t doy = floor_div64(153 * mp + 2, 5) + d - 1;
  const int64_t doe =
      yoe * 365 + floor_div64(yoe, 4) - floor_div64(yoe, 100) + doy;
  return era * 146097 + doe - 719468;
}

// part 0 year, 1 month, 2 day, 3 quarter, 4 day of year, 5 last day of
// the month (epoch days)
SRT_HD int64_t civil_part(int64_t days, int part) {
  int64_t y, m, d;
  civil(days, &y, &m, &d);
  switch (part) {
    case 0: return y;
    case 1: return m;
    case 2: return d;
    case 3: return floor_div64(m - 1, 3) + 1;
    case 4: return days - days_from_civil(y, 1, 1) + 1;
    default: {
      const int64_t ny = m == 12 ? y + 1 : y;
      const int64_t nm = m == 12 ? 1 : m + 1;
      return days_from_civil(ny, nm, 1) - 1;
    }
  }
}

SRT_HD double math1(int op, double x) {
  switch (op) {
    case SIN: return sin(x);
    case COS: return cos(x);
    case TAN: return tan(x);
    case ASIN: return asin(x);
    case ACOS: return acos(x);
    case ATAN: return atan(x);
    case SINH: return sinh(x);
    case COSH: return cosh(x);
    case TANH: return tanh(x);
    case ASINH: return asinh(x);
    case ACOSH: return acosh(x);
    case ATANH: return atanh(x);
    case SQRT: return sqrt(x);
    case CBRT: return cbrt(x);
    case EXP: return exp(x);
    case EXPM1: return expm1(x);
    case LOG: return log(x);
    case LOG1P: return log1p(x);
    case LOG2: return log2(x);
    case LOG10: return log10(x);
    case RINT: return rint(x);
    case DEGREES: return x * 57.29577951308232;
    case RADIANS: return x * 0.017453292519943295;
    default: return 1.0 / tan(x);  // COT
  }
}

SRT_HD float math1f(int op, float x) {
  switch (op) {
    case SIN: return sinf(x);
    case COS: return cosf(x);
    case TAN: return tanf(x);
    case ASIN: return asinf(x);
    case ACOS: return acosf(x);
    case ATAN: return atanf(x);
    case SINH: return sinhf(x);
    case COSH: return coshf(x);
    case TANH: return tanhf(x);
    case ASINH: return asinhf(x);
    case ACOSH: return acoshf(x);
    case ATANH: return atanhf(x);
    case SQRT: return sqrtf(x);
    case CBRT: return cbrtf(x);
    case EXP: return expf(x);
    case EXPM1: return expm1f(x);
    case LOG: return logf(x);
    case LOG1P: return log1pf(x);
    case LOG2: return log2f(x);
    case LOG10: return log10f(x);
    case RINT: return rintf(x);
    case DEGREES: return x * (float)57.29577951308232;
    case RADIANS: return x * (float)0.017453292519943295;
    default: return 1.0f / tanf(x);  // COT
  }
}

SRT_HD bool word_nan(uint64_t w, int t) {
  if (!is_float(t)) return false;
  const double d = as_f(w);
  return d != d;
}

SRT_HD bool truth(uint64_t w, int t) {
  return is_float(t) ? as_f(w) != 0.0 : w != 0;
}

// one comparison of two words of type t (IEEE for floats)
SRT_HD bool compare(int op, uint64_t a, uint64_t b, int t) {
  if (is_float(t)) {
    const double x = as_f(a), y = as_f(b);
    switch (op) {
      case EQ: return x == y;
      case LT: return x < y;
      case LE: return x <= y;
      case GT: return x > y;
      default: return x >= y;
    }
  }
  const int64_t x = (int64_t)a, y = (int64_t)b;
  switch (op) {
    case EQ: return x == y;
    case LT: return x < y;
    case LE: return x <= y;
    case GT: return x > y;
    default: return x >= y;
  }
}

// A row's register file: value word and validity byte of register r.
struct Regs {
  uint64_t* v;
  uint8_t* n;
  long long stride;
  SRT_HD uint64_t& val(long long r) const { return v[r * stride]; }
  SRT_HD uint8_t& ok(long long r) const { return n[r * stride]; }
};

// The columns of one launch: element type codes, data and validity.
struct Cols {
  const long long* data;   // pointers
  const long long* valid;  // pointers
  const long long* kind;   // Type codes
};

SRT_HD uint64_t load_elem(const void* p, int kind, long long row) {
  switch (kind) {
    case T_BOOL: return ((const uint8_t*)p)[row] ? 1u : 0u;
    case T_I8: return (uint64_t)(int64_t)((const int8_t*)p)[row];
    case T_I16: return (uint64_t)(int64_t)((const int16_t*)p)[row];
    case T_I32: return (uint64_t)(int64_t)((const int32_t*)p)[row];
    case T_I64: return (uint64_t)((const int64_t*)p)[row];
    case T_F32: return from_f((double)((const float*)p)[row]);
    case T_F64: return from_f(((const double*)p)[row]);
    default: return 0;
  }
}

SRT_HD void store_elem(void* p, int kind, long long row, uint64_t w) {
  switch (kind) {
    case T_BOOL: ((uint8_t*)p)[row] = (uint8_t)(w & 1u); break;
    case T_I8: ((int8_t*)p)[row] = (int8_t)(uint8_t)w; break;
    case T_I16: ((int16_t*)p)[row] = (int16_t)(uint16_t)w; break;
    case T_I32: ((int32_t*)p)[row] = (int32_t)(uint32_t)w; break;
    case T_I64: ((int64_t*)p)[row] = (int64_t)w; break;
    case T_F32: ((float*)p)[row] = (float)as_f(w); break;
    default: ((double*)p)[row] = as_f(w); break;
  }
}

// Runs the program for one row. `live` is row < num_rows: a row past it
// loads NULL, stores NULL and keeps nothing. keep (when the program has a
// KEEP) starts as `live` and is ANDed with each KEEP's truth.
SRT_HD void run_row(const long long* prog, int n_instr, const Regs& R,
                    long long row, bool live, const Cols& in,
                    const Cols& out, uint8_t* keep) {
  bool kept = live;
  bool has_keep = false;
  for (int k = 0; k < n_instr; ++k) {
    const long long* I = prog + (long long)k * kWords;
    const int op = (int)I[0];
    const int t = (int)I[1];
    const long long dst = I[2], ia = I[3], ib = I[4], ic = I[5];
    const uint64_t imm = (uint64_t)I[6];
    uint64_t r = 0;
    bool ok = true;
    if (op == LOAD) {
      const int kind = (int)in.kind[ia];
      const uint8_t* vp = (const uint8_t*)in.valid[ia];
      ok = live && (vp == nullptr || vp[row] != 0);
      if (ok && kind != T_VALID)
        r = load_elem((const void*)in.data[ia], kind, row);
    } else if (op == STORE) {
      const bool v = live && R.ok(ia);
      const int kind = (int)out.kind[ib];
      store_elem((void*)out.data[ib], kind, row, v ? R.val(ia) : 0);
      ((uint8_t*)out.valid[ib])[row] = v ? 1 : 0;
      continue;
    } else if (op == KEEP) {
      has_keep = true;
      kept = kept && R.ok(ia) && truth(R.val(ia), t);
      continue;
    } else if (op == CONST) {
      r = imm;
    } else if (op == NULLC) {
      ok = false;
    } else {
      const uint64_t a = ia >= 0 ? R.val(ia) : 0;
      const bool va = ia >= 0 ? R.ok(ia) != 0 : true;
      // a CAST's b is its source type, not a register
      const bool b_reg = ib >= 0 && op != CAST;
      const uint64_t b = b_reg ? R.val(ib) : 0;
      const bool vb = b_reg ? R.ok(ib) != 0 : true;
      const uint64_t c = ic >= 0 ? R.val(ic) : 0;
      const bool vc = ic >= 0 ? R.ok(ic) != 0 : true;
      switch (op) {
        case CAST:
          ok = va;
          r = convert(a, (int)ib, t);
          break;
        case ADD: case SUB: case MUL:
          ok = va && vb;
          if (is_float(t)) {
            if (t == T_F32) {
              const float x = (float)as_f(a), y = (float)as_f(b);
              const float z = op == ADD ? x + y : op == SUB ? x - y : x * y;
              r = from_f((double)z);
            } else {
              const double x = as_f(a), y = as_f(b);
              r = from_f(op == ADD ? x + y : op == SUB ? x - y : x * y);
            }
          } else {
            const uint64_t z = op == ADD ? a + b : op == SUB ? a - b : a * b;
            r = (uint64_t)wrap(z, t);
          }
          break;
        case DIV: {
          const double y = as_f(b);
          ok = va && vb && y != 0.0;
          if (t == T_F32)
            r = from_f((double)((float)as_f(a) / (float)(y == 0.0 ? 1.0 : y)));
          else
            r = from_f(as_f(a) / (y == 0.0 ? 1.0 : y));
          break;
        }
        case REM: case PMOD: case IDIV: case FDIV: case FMOD: {
          ok = va && vb && !(is_float(t) ? as_f(b) == 0.0 : b == 0);
          if (!ok) break;
          if (is_float(t)) {
            const double x = as_f(a), y = as_f(b);
            double m = t == T_F32 ? (double)fmodf((float)x, (float)y)
                                  : fmod(x, y);
            if (op == PMOD && m < 0)
              m = t == T_F32 ? (double)fmodf((float)m + (float)y, (float)y)
                             : fmod(m + y, y);
            r = from_f(m);
          } else {
            const int64_t x = (int64_t)a, y = (int64_t)b;
            if (op == IDIV) {
              r = y == -1 ? (uint64_t)wrap(0 - a, t) : (uint64_t)(x / y);
            } else if (op == FDIV) {
              r = (uint64_t)wrap((uint64_t)floor_div64(x, y), t);
            } else if (op == FMOD) {
              r = (uint64_t)floor_mod64(x, y);
            } else {
              int64_t m = trunc_mod64(x, y);
              // pmod's fix-up m + y runs in 64 bits: exact for a narrower
              // type (the reference widens it), wrapping for INT64
              if (op == PMOD && m < 0)
                m = trunc_mod64((int64_t)((uint64_t)m + (uint64_t)y), y);
              r = (uint64_t)wrap((uint64_t)m, t);
            }
          }
          break;
        }
        case NEG:
          ok = va;
          r = is_float(t) ? from_f(-as_f(a)) : (uint64_t)wrap(0 - a, t);
          break;
        case ABS:
          ok = va;
          if (is_float(t))
            r = from_f(fabs(as_f(a)));
          else
            r = (int64_t)a < 0 ? (uint64_t)wrap(0 - a, t) : a;
          break;
        case SIGNUM:
          ok = va;
          if (is_float(t)) {
            const double x = as_f(a);
            r = from_f(x > 0 ? 1.0 : x < 0 ? -1.0 : x);
          } else {
            const int64_t x = (int64_t)a;
            r = (uint64_t)(int64_t)(x > 0 ? 1 : x < 0 ? -1 : 0);
          }
          break;
        case EQ: case LT: case LE: case GT: case GE:
          ok = va && vb;
          r = compare(op, a, b, t) ? 1u : 0u;
          break;
        case EQNS:
          r = ((va && vb && compare(EQ, a, b, t)) || (!va && !vb)) ? 1u : 0u;
          ok = live;
          break;
        case AND: {
          const bool x = a != 0, y = b != 0;
          const bool false_somewhere = (!x && va) || (!y && vb);
          ok = (va && vb) || false_somewhere;
          r = (x && y && ok) ? 1u : 0u;
          break;
        }
        case OR: {
          const bool x = a != 0, y = b != 0;
          const bool true_somewhere = (x && va) || (y && vb);
          ok = (va && vb) || true_somewhere;
          r = ((x || y) && ok) ? 1u : 0u;
          break;
        }
        case NOT:
          ok = va;
          r = a != 0 ? 0u : 1u;
          break;
        case ANYEQ:
          // a data-only equality against an immediate, ORed into b
          r = ((ib >= 0 && b != 0) || compare(EQ, a, imm, t)) ? 1u : 0u;
          break;
        case INFIN: {
          // a: the IN's value, b: its accumulated matches, imm: 1 when a
          // candidate is NULL
          ok = va && (b != 0 || imm == 0);
          r = (b != 0 && ok) ? 1u : 0u;
          break;
        }
        case ISNULL:
          r = va ? 0u : 1u;
          ok = live;
          break;
        case ISNOTNULL:
          r = va ? 1u : 0u;
          ok = live;
          break;
        case ISNAN:
          r = (va && word_nan(a, t)) ? 1u : 0u;
          ok = live;
          break;
        case NANVL:
          ok = va && vb;
          r = word_nan(a, t) ? b : a;
          break;
        case COALESCE:
          ok = va || vb;
          r = va ? a : b;
          break;
        case CNTNN: {
          const int64_t acc = ib >= 0 ? (int64_t)b : 0;
          r = (uint64_t)(acc + ((va && !word_nan(a, t)) ? 1 : 0));
          break;
        }
        case SELECT: {
          const bool take = va && a != 0;
          r = take ? b : c;
          ok = take ? vb : vc;
          break;
        }
        case BAND: ok = va && vb; r = a & b; break;
        case BOR: ok = va && vb; r = a | b; break;
        case BXOR: ok = va && vb; r = (uint64_t)wrap(a ^ b, t); break;
        case BNOT:
          ok = va;
          r = t == T_BOOL ? (a != 0 ? 0u : 1u) : (uint64_t)wrap(~a, t);
          break;
        case SHL: case SHR: case USHR: {
          ok = va && vb;
          const int w = width(t);
          const int s = (int)floor_mod64((int64_t)b, w);
          if (op == SHL) {
            r = (uint64_t)wrap(a << s, t);
          } else if (op == SHR) {
            r = (uint64_t)((int64_t)a >> s);
          } else {
            const uint64_t mask = w == 64 ? ~0ull : ((1ull << w) - 1);
            r = (uint64_t)wrap((a & mask) >> s, t);
          }
          break;
        }
        case CIVIL:
          ok = va;
          r = (uint64_t)wrap((uint64_t)civil_part((int64_t)a, (int)imm), t);
          break;
        case NORMNAN: {
          ok = va;
          const double x = as_f(a);
          r = x != x ? from_f(NAN) : x == 0.0 ? from_f(0.0) : a;
          break;
        }
        case FLOOR: case CEIL: {
          ok = va;
          const double x = as_f(a);
          r = convert(from_f(op == FLOOR ? floor(x) : ceil(x)), T_F64, T_I64);
          break;
        }
        case POW: case ATAN2: case LOGB: {
          ok = va && vb;
          const double x = as_f(a), y = as_f(b);
          r = from_f(op == POW ? pow(x, y)
                               : op == ATAN2 ? atan2(x, y) : log(x) / log(y));
          break;
        }
        default:  // the one-argument math ops
          ok = va;
          if (t == T_F32)
            r = from_f((double)math1f(op, (float)as_f(a)));
          else
            r = from_f(math1(op, as_f(a)));
          break;
      }
    }
    R.val(dst) = ok ? r : 0;
    R.ok(dst) = ok ? 1 : 0;
  }
  if (keep != nullptr && has_keep) keep[row] = kept ? 1 : 0;
}

}  // namespace srt_stage
