// The spin temperature's per-shell cell chain for Hopper (sm_90a), bound with
// ctypes: two kernels a shell of the Eulerian Ts shell scan.
//
// Replaces no TPU kernel: the JAX package's `_ts_shell_scan`
// (py21cmfast_tpu/models/spintemp.py) is left to XLA, which fuses the chain on
// the TPU.  Added because the port ran that chain as some 130 PyTorch ops a
// shell, each reading and writing whole lowres grids: at HII_DIM 256 ~40
// shells took ~0.25 s of device time a Ts step, about 5% of the chain's byte
// bound.  It computes, per cell and shell, what
// models/spintemp.py::_eulerian_shell_terms and the accumulate of
// `_ts_shell_scan` compute for single-device Eulerian sources without
// minihalos; the k-space window and the inverse FFT stay in PyTorch.
//
// Function, per shell, from the filtered field delta0 (z = 0 units):
//   dz    = max(delta0, -1/D(z_pf)) * growth                (delta at z'')
//   fcoll = exp(Chebyshev fit of log SFRD(dz), blended to the table edge)
//           or the linear gather of the shell's 400-point SFRD table;
//           `cap` at dz >= d_hi, then at least 1e-35
//   ave   = mean over the grid of fcoll (CONST-ION-EFF: of the fcoll table,
//           1 at dz >= d_hi), at least 1e-35
//   sfr   = (1 + dz) * (fcoll / ave) * zfac * mean_sfrd * fstar10
//   xray  = sfr * xr_fac
// and adds into the accumulators, with each cell's x_e interpolated on the
// 14 X_INT_XHII knots: dxheat += xray * heat(x_e), dxion += xray * ion(x_e),
// dxlya += xray * lya(x_e), dstarlya += sfr * p_star, and under Lya heating
// dlya_cont += sfr * p_cont, dlya_inj += sfr * p_inj.
//
// Bound: the mean needs one read of delta0 (4 B a cell); the accumulate one
// more read of it and of x_e (8 B) and one read-modify-write of each
// accumulator (8 B each, 48 B with six): 4 + 56 B a cell a shell, 1.0 GB and
// 0.30 ms a shell at 256^3 and 3.35 TB/s.  The arithmetic (a 16-degree
// Clenshaw, an exp, ~80 flops a cell) is far below the card's rate.
//
// Design:
//  * Two launches a shell, because the accumulate needs the grid's mean
//    first.  `ts_shell_reduce` computes fcoll (or the CONST-ION-EFF fcoll) in
//    registers and writes one double partial sum a block; it writes nothing
//    else.  `ts_shell_accumulate` sums the partials, recomputes fcoll from
//    delta0 (cheaper than storing and reading it back: 4 B against 8 B a
//    cell) and updates the accumulators in place.  No fcoll, dz, sfr or
//    table-index grid ever reaches device memory.
//  * The reduction is deterministic: each thread sums its cells in a fixed
//    order, each block its threads in a fixed tree, and every accumulate
//    block sums the same partials in the same order; no float atomics.  The
//    grid is at most TS_MAX_BLOCKS blocks whatever the card, so the sum does
//    not depend on the device's SM count either.
//  * The shell's scalars, its Chebyshev coefficients and its three 14-point
//    frequency tables come by value as one kernel parameter (TsShellConsts,
//    284 B), the step's own constants (the aliasing floor, f_star10 and the
//    14 x_e knots) as another (TsStepConsts, 64 B), well inside the 4 KB a
//    launch may carry: nothing is uploaded a shell.  The gather path's table
//    row and the tables indexed per cell are copied into shared memory at
//    the block's start.
//  * Each rounding is the plain version's: every add, multiply and divide is
//    an explicitly rounded intrinsic (no FMA contraction), in the order the
//    PyTorch ops take, so a cell differs from the plain version only where
//    PyTorch divides by a host scalar as a multiply by its reciprocal, and by
//    the mean's summation order.
//  * Loads and stores are 16-byte vectors (the wrapper checks the alignment),
//    four cells a thread an iteration; a scalar loop takes the last n % 4.
//  * Three table modes (Chebyshev, gather, CONST-ION-EFF) and the two
//    accumulator flags are template parameters of one kernel pair.

#include <cuda_runtime.h>
#include <stdint.h>

#define TS_N_CHEB 17
#define TS_N_XE 14
#define TS_N_DELTA 400
#define TS_THREADS 256
#define TS_MAX_BLOCKS 1024
#define TS_CHEBY_X_SAFE 0.98f

// one shell's constants, float32 as the plain version rounds them; the layout
// is ops/ts_shell.py's ShellConsts, field for field
struct TsShellConsts {
    float R, growth, zfac, xr_fac, d_lo, d_hi, cap, mean_sfrd;
    float p_star, p_cont, p_inj;
    float cheb[TS_N_CHEB];
    float cheb_edge;
    float tbl_heat[TS_N_XE], tbl_ion[TS_N_XE], tbl_lya[TS_N_XE];
};
static_assert(sizeof(TsShellConsts) == 71 * sizeof(float), "TsShellConsts is 71 packed floats");

// the Ts step's constants, the same for every shell: ops/ts_shell.py's
// StepConsts, field for field
struct TsStepConsts {
    float inv_growth_pf, fstar10;
    float xhii[TS_N_XE];
};
static_assert(sizeof(TsStepConsts) == 16 * sizeof(float), "TsStepConsts is 16 packed floats");

enum { MODE_CHEBY = 0, MODE_GATHER = 1, MODE_CONST = 2 };

struct AccArgs {
    const float* delta0;
    const float* xe;
    float* heat;
    float* ion;
    float* lya;
    float* star;
    float* cont;
    float* inj;
    const float* table;  // the shell's SFRD table row (gather, CONST-ION-EFF)
    const double* partials;
    int n_partials;
    long long n;
};

// torch.clamp_min / clamp_max / clamp: a NaN passes through
__device__ __forceinline__ float clamp_min_(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max_(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clamp_(float x, float lo, float hi) { return clamp_max_(clamp_min_(x, lo), hi); }

// delta at z'': the aliasing floor at -1/D(z_pf), then the growth
__device__ __forceinline__ float delta_zpp(float d, const TsStepConsts& st, const TsShellConsts& c) {
    return __fmul_rn(clamp_min_(d, -st.inv_growth_pf), c.growth);
}

// position on the 400-point table axis
__device__ __forceinline__ float table_pos(float dz, const TsShellConsts& c, float span) {
    const float t = __fmul_rn(__fdiv_rn(__fsub_rn(dz, c.d_lo), span), (float)(TS_N_DELTA - 1));
    return clamp_(t, 0.0f, (float)(TS_N_DELTA - 1.001));
}

__device__ __forceinline__ float lerp_table(const float* tab, float t) {
    const int i0 = (int)t;  // t >= 0 after the clamp: truncation is a floor
    const float frac = __fsub_rn(t, (float)i0);
    return __fadd_rn(__fmul_rn(tab[i0], __fsub_rn(1.0f, frac)), __fmul_rn(tab[i0 + 1], frac));
}

// the conditional SFRD of one cell before the cap: log-Chebyshev Clenshaw
// blended to the table edge, or the table gather
template <int MODE>
__device__ __forceinline__ float sfrd(float dz, const TsShellConsts& c, float span, const float* s_tab) {
    if (MODE == MODE_CHEBY) {
        const float xch = clamp_(
            __fsub_rn(__fmul_rn(__fdiv_rn(__fsub_rn(dz, c.d_lo), span), 2.0f), 1.0f), -1.0f, 1.0f);
        const float x = clamp_max_(xch, TS_CHEBY_X_SAFE);
        const float two_x = __fmul_rn(2.0f, x);
        float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
        for (int k = TS_N_CHEB - 1; k > 0; --k) {
            const float b = __fsub_rn(__fadd_rn(c.cheb[k], __fmul_rn(two_x, b1)), b2);
            b2 = b1;
            b1 = b;
        }
        const float flog = __fsub_rn(__fadd_rn(c.cheb[0], __fmul_rn(x, b1)), b2);
        const float blend = clamp_(
            __fdiv_rn(__fsub_rn(xch, TS_CHEBY_X_SAFE), (float)(1.0 - 0.98)), 0.0f, 1.0f);
        return expf(__fadd_rn(__fmul_rn(flog, __fsub_rn(1.0f, blend)), __fmul_rn(c.cheb_edge, blend)));
    } else {
        return lerp_table(s_tab, table_pos(dz, c, span));
    }
}

// the SFR proxy of the shell's sources: capped at d_hi, at least 1e-35
template <int MODE>
__device__ __forceinline__ float fcoll_of(float dz, const TsShellConsts& c, float span, const float* s_tab) {
    const float f = dz >= c.d_hi ? c.cap : sfrd<MODE>(dz, c, span, s_tab);
    return clamp_min_(f, 1e-35f);
}

// what the shell's mean is taken of: fcoll, or under CONST-ION-EFF the
// plain fcoll table (s_tab then holds it), 1 at d_hi
template <int MODE>
__device__ __forceinline__ float mean_term(float d, const TsStepConsts& st, const TsShellConsts& c,
                                           float span, const float* s_tab) {
    const float dz = delta_zpp(d, st, c);
    if (MODE == MODE_CONST) return dz >= c.d_hi ? 1.0f : lerp_table(s_tab, table_pos(dz, c, span));
    return fcoll_of<MODE>(dz, c, span, s_tab);
}

template <int MODE>
__global__ void __launch_bounds__(TS_THREADS)
ts_shell_reduce_kernel(const float* __restrict__ delta0, const float* __restrict__ table,
                       double* __restrict__ partials, long long n, TsStepConsts st,
                       TsShellConsts c)
{
    __shared__ float s_tab[TS_N_DELTA];
    __shared__ double s_warp[TS_THREADS / 32];
    if (MODE != MODE_CHEBY) {
        for (int j = threadIdx.x; j < TS_N_DELTA; j += TS_THREADS) s_tab[j] = table[j];
        __syncthreads();
    }
    const float span = __fsub_rn(c.d_hi, c.d_lo);
    const long long n4 = n / 4;
    const long long stride = (long long)gridDim.x * TS_THREADS;
    const long long first = (long long)blockIdx.x * TS_THREADS + threadIdx.x;
    const float4* d4 = reinterpret_cast<const float4*>(delta0);
    double s = 0.0;
    for (long long q = first; q < n4; q += stride) {
        const float4 d = d4[q];
        s += (double)mean_term<MODE>(d.x, st, c, span, s_tab);
        s += (double)mean_term<MODE>(d.y, st, c, span, s_tab);
        s += (double)mean_term<MODE>(d.z, st, c, span, s_tab);
        s += (double)mean_term<MODE>(d.w, st, c, span, s_tab);
    }
    for (long long i = 4 * n4 + first; i < n; i += stride) s += (double)mean_term<MODE>(delta0[i], st, c, span, s_tab);

    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        double t = 0.0;
        for (int w = 0; w < TS_THREADS / 32; ++w) t += s_warp[w];
        partials[blockIdx.x] = t;
    }
}

// one cell's accumulate; `j`/`ival` index x_e on the knots
template <int MODE, bool XHEAT, bool LYA>
__device__ __forceinline__ void accumulate_cell(
    float d, float xe, float& heat, float& ion, float& lya, float& star, float& cont, float& inj,
    const TsStepConsts& st, const TsShellConsts& c, float span, float ave, float scale,
    float xe_lo, float xe_hi, const float* s_tab, const float* s_xhii, const float* s_heat,
    const float* s_ion, const float* s_lya)
{
    const float dz = delta_zpp(d, st, c);
    const float fcoll = fcoll_of<MODE>(dz, c, span, s_tab);
    // the O(1) grid/mean ratio before the global scale (see
    // _eulerian_shell_terms: mean_sfrd / ave overflows float32)
    const float sfr = __fmul_rn(__fmul_rn(__fadd_rn(1.0f, dz), __fdiv_rn(fcoll, ave)), scale);
    const float xray = __fmul_rn(sfr, c.xr_fac);

    // the count of knots <= x_e, less one
    const float x = clamp_(xe, xe_lo, xe_hi);
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < TS_N_XE; ++k) cnt += (st.xhii[k] <= x) ? 1 : 0;
    const int j = cnt - 1 < 0 ? 0 : (cnt - 1 > TS_N_XE - 2 ? TS_N_XE - 2 : cnt - 1);
    const float ival = __fdiv_rn(__fsub_rn(x, s_xhii[j]), __fsub_rn(s_xhii[j + 1], s_xhii[j]));
#define TS_FREQ(tb) __fadd_rn(tb[j], __fmul_rn(ival, __fsub_rn(tb[j + 1], tb[j])))
    if (XHEAT) heat = __fadd_rn(heat, __fmul_rn(xray, TS_FREQ(s_heat)));
    ion = __fadd_rn(ion, __fmul_rn(xray, TS_FREQ(s_ion)));
    lya = __fadd_rn(lya, __fmul_rn(xray, TS_FREQ(s_lya)));
#undef TS_FREQ
    star = __fadd_rn(star, __fmul_rn(sfr, c.p_star));
    if (LYA) {
        cont = __fadd_rn(cont, __fmul_rn(sfr, c.p_cont));
        inj = __fadd_rn(inj, __fmul_rn(sfr, c.p_inj));
    }
}

template <int MODE, bool XHEAT, bool LYA>
__global__ void __launch_bounds__(TS_THREADS)
ts_shell_accumulate_kernel(AccArgs a, TsStepConsts st, TsShellConsts c)
{
    __shared__ float s_tab[TS_N_DELTA];
    __shared__ float s_xhii[TS_N_XE], s_heat[TS_N_XE], s_ion[TS_N_XE], s_lya[TS_N_XE];
    __shared__ double s_total;
    if (MODE != MODE_CHEBY)
        for (int j = threadIdx.x; j < TS_N_DELTA; j += TS_THREADS) s_tab[j] = a.table[j];
    if (threadIdx.x == 0) {
        // constant indices: the parameter is read in place, never copied
#pragma unroll
        for (int k = 0; k < TS_N_XE; ++k) {
            s_xhii[k] = st.xhii[k];
            s_heat[k] = c.tbl_heat[k];
            s_ion[k] = c.tbl_ion[k];
            s_lya[k] = c.tbl_lya[k];
        }
    }
    if (threadIdx.x < 32) {
        // every block sums the same partials in the same order
        double t = 0.0;
        for (int j = threadIdx.x; j < a.n_partials; j += 32) t += a.partials[j];
        for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
        if (threadIdx.x == 0) s_total = t;
    }
    __syncthreads();
    const float m = (float)(s_total / (double)a.n);
    const float ave = clamp_min_(m, 1e-35f);
    const float span = __fsub_rn(c.d_hi, c.d_lo);
    const float scale = __fmul_rn(__fmul_rn(c.zfac, c.mean_sfrd), st.fstar10);
    const float xe_lo = __fmul_rn(st.xhii[0], 1.001f);
    const float xe_hi = __fmul_rn(st.xhii[TS_N_XE - 1], 0.999f);

    const long long n4 = a.n / 4;
    const long long stride = (long long)gridDim.x * TS_THREADS;
    const long long first = (long long)blockIdx.x * TS_THREADS + threadIdx.x;
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long q = first; q < n4; q += stride) {
        const float4 d = reinterpret_cast<const float4*>(a.delta0)[q];
        const float4 xe = reinterpret_cast<const float4*>(a.xe)[q];
        float4 heat = XHEAT ? reinterpret_cast<const float4*>(a.heat)[q] : zero4;
        float4 ion = reinterpret_cast<const float4*>(a.ion)[q];
        float4 lya = reinterpret_cast<const float4*>(a.lya)[q];
        float4 star = reinterpret_cast<const float4*>(a.star)[q];
        float4 cont = LYA ? reinterpret_cast<const float4*>(a.cont)[q] : zero4;
        float4 inj = LYA ? reinterpret_cast<const float4*>(a.inj)[q] : zero4;
#define TS_CELL(f)                                                                              \
        accumulate_cell<MODE, XHEAT, LYA>(d.f, xe.f, heat.f, ion.f, lya.f, star.f, cont.f, inj.f, \
                                          st, c, span, ave, scale, xe_lo, xe_hi, s_tab, s_xhii, \
                                          s_heat, s_ion, s_lya)
        TS_CELL(x);
        TS_CELL(y);
        TS_CELL(z);
        TS_CELL(w);
#undef TS_CELL
        if (XHEAT) reinterpret_cast<float4*>(a.heat)[q] = heat;
        reinterpret_cast<float4*>(a.ion)[q] = ion;
        reinterpret_cast<float4*>(a.lya)[q] = lya;
        reinterpret_cast<float4*>(a.star)[q] = star;
        if (LYA) {
            reinterpret_cast<float4*>(a.cont)[q] = cont;
            reinterpret_cast<float4*>(a.inj)[q] = inj;
        }
    }
    for (long long i = 4 * n4 + first; i < a.n; i += stride) {
        float heat = XHEAT ? a.heat[i] : 0.f, ion = a.ion[i], lya = a.lya[i], star = a.star[i];
        float cont = LYA ? a.cont[i] : 0.f, inj = LYA ? a.inj[i] : 0.f;
        accumulate_cell<MODE, XHEAT, LYA>(a.delta0[i], a.xe[i], heat, ion, lya, star, cont, inj,
                                          st, c, span, ave, scale, xe_lo, xe_hi, s_tab, s_xhii,
                                          s_heat, s_ion, s_lya);
        if (XHEAT) a.heat[i] = heat;
        a.ion[i] = ion;
        a.lya[i] = lya;
        a.star[i] = star;
        if (LYA) {
            a.cont[i] = cont;
            a.inj[i] = inj;
        }
    }
}

static int host_blocks(long long n) {
    const long long n4 = (n + 3) / 4;
    long long b = (n4 + TS_THREADS - 1) / TS_THREADS;
    return (int)(b < 1 ? 1 : (b > TS_MAX_BLOCKS ? TS_MAX_BLOCKS : b));
}

template <int MODE, bool XHEAT, bool LYA>
static void launch_accumulate(const AccArgs& a, const TsStepConsts& st, const TsShellConsts& c,
                              cudaStream_t s) {
    ts_shell_accumulate_kernel<MODE, XHEAT, LYA><<<host_blocks(a.n), TS_THREADS, 0, s>>>(a, st, c);
}

template <int MODE>
static void launch_accumulate_flags(const AccArgs& a, const TsStepConsts& st, const TsShellConsts& c,
                                    bool xheat, bool lya, cudaStream_t s) {
    if (xheat) {
        if (lya) launch_accumulate<MODE, true, true>(a, st, c, s);
        else launch_accumulate<MODE, true, false>(a, st, c, s);
    } else {
        if (lya) launch_accumulate<MODE, false, true>(a, st, c, s);
        else launch_accumulate<MODE, false, false>(a, st, c, s);
    }
}

// The number of partial sums ts_shell_reduce writes for n cells (the size of
// the scratch buffer the caller allocates).
extern "C" int ts_shell_partials(long long n) { return host_blocks(n); }

static bool consts_sizes_ok(int step_size, int consts_size) {
    return step_size == (int)sizeof(TsStepConsts) && consts_size == (int)sizeof(TsShellConsts);
}

// The grid's partial sums of the shell's fcoll (CONST-ION-EFF: of its fcoll
// table); `table` is the shell's 400-point row of the SFRD table (gather) or
// of the fcoll table (CONST-ION-EFF), unused under the Chebyshev fit.
extern "C" int ts_shell_reduce(const float* delta0, const float* table, double* partials,
                               long long n, int mode, const TsStepConsts* step, int step_size,
                               const TsShellConsts* consts, int consts_size, void* stream)
{
    if (n < 1 || !consts_sizes_ok(step_size, consts_size)) return (int)cudaErrorInvalidValue;
    const TsStepConsts st = *step;
    const TsShellConsts c = *consts;
    cudaStream_t s = (cudaStream_t)stream;
    const int nb = host_blocks(n);
    switch (mode) {
        case MODE_CHEBY: ts_shell_reduce_kernel<MODE_CHEBY><<<nb, TS_THREADS, 0, s>>>(delta0, table, partials, n, st, c); break;
        case MODE_GATHER: ts_shell_reduce_kernel<MODE_GATHER><<<nb, TS_THREADS, 0, s>>>(delta0, table, partials, n, st, c); break;
        case MODE_CONST: ts_shell_reduce_kernel<MODE_CONST><<<nb, TS_THREADS, 0, s>>>(delta0, table, partials, n, st, c); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// Adds the shell's terms into the accumulators in place (heat, cont and inj
// may be null where their flag is off); `table` is the shell's SFRD table row
// (gather and CONST-ION-EFF), `partials` what ts_shell_reduce wrote.
extern "C" int ts_shell_accumulate(const float* delta0, const float* xe, float* heat, float* ion,
                                   float* lya, float* star, float* cont, float* inj,
                                   const float* table, const double* partials, long long n,
                                   int mode, int xheat, int lya_heat, const TsStepConsts* step,
                                   int step_size, const TsShellConsts* consts, int consts_size,
                                   void* stream)
{
    if (n < 1 || !consts_sizes_ok(step_size, consts_size)) return (int)cudaErrorInvalidValue;
    const TsStepConsts st = *step;
    const TsShellConsts c = *consts;
    const AccArgs a = {delta0, xe, heat, ion, lya, star, cont, inj, table, partials,
                       host_blocks(n), n};
    cudaStream_t s = (cudaStream_t)stream;
    switch (mode) {
        case MODE_CHEBY: launch_accumulate_flags<MODE_CHEBY>(a, st, c, xheat != 0, lya_heat != 0, s); break;
        case MODE_GATHER: launch_accumulate_flags<MODE_GATHER>(a, st, c, xheat != 0, lya_heat != 0, s); break;
        case MODE_CONST: launch_accumulate_flags<MODE_CONST>(a, st, c, xheat != 0, lya_heat != 0, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
