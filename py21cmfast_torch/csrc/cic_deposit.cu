// Swept 2LPT cloud-in-cell deposit for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel py21cmfast_tpu/ops/pallas_deposit.py::_deposit_kernel
// (the dense factored pass entered through pallas_factored_deposit) together
// with its exact outlier pass, outlier_scatter_from_stack: it computes the
// result of models/perturb.py::_pallas_deposit, not the TPU's block layout.
//
// Function: on each axis a hires index decomposes into the lowres channel cell
// c = ((h + R/2) / R) mod n and the centred residual s = (h + R/2) mod R - R/2
// (ops/deposit.py `_chan`: the last partial channel wraps to c = 0).  The
// sub-particle has mass m = 1 + delta_h * D_init and lands at
// p = c + d(c) + s/R in lowres cells, d being the lowres displacement; its
// eight trilinear weights are added into the zeroed lowres grid with periodic
// wrap.  Every particle is deposited: no support limit, no mask, no outlier
// pass.
//
// Bound: DIM^3 floats of hires density and three lowres displacement grids
// read once, one lowres grid written: 260 MB, 78 us at 3.35 TB/s for
// 384^3 -> 128^3; the arithmetic needs half of that.  What costs time is the
// scatter: one global atomicAdd per weight (8 DIM^3 = 4.5e8, a warp's lanes
// mostly on the same few addresses) took 2.4 ms on an H100 80GB HBM3 at 700 W.
//
// Design:
//  * A block owns a brick of BX x BY x BZ channel cells and accumulates into a
//    zeroed shared-memory tile that covers the brick plus a halo of H cells
//    below and H + 1 above on each axis.  At the end it flushes every non-zero
//    tile cell with one global atomicAdd at the periodically wrapped index
//    (several tile cells may wrap onto one global cell on a small grid).
//  * One thread per channel cell ("level 2").  Its R^3 sub-particles share
//    d(c) and span (R-1)/R < 1 cell per axis, so they touch at most 3 cells
//    per axis, and their weights factor by axis: the thread sums m * wz over
//    sz into 3 registers, folds those with wy over sy into 9, those with wx
//    over sx into 27, and issues at most 27 shared atomics (zeros are
//    skipped) instead of 8 R^3.  A warp's lanes are 32 different channels, so
//    they rarely meet on one address.  The hires reads of a warp are strided
//    by R floats; the R reads that share a line are served by L1.
//  * The tile is fixed point.  A float atomicAdd on shared memory is not one
//    instruction on this card: it compiles to a load and a compare-and-swap
//    loop (LDS + ATOMS.CAST.SPIN), and a float tile was slower for it (PERF.md).
//    An integer atomicAdd is native (ATOMS.ADD).
//    So a thread converts each of its 27 sums to a signed 32-bit integer in
//    units of 2^-shift (shift = 23 - ceil(log2 R^3): under 2.4e-7 of the
//    mean cell mass, where float32 rounds such a cell to 1.2e-7) and adds
//    that.  A tile cell that overflows is caught from the value atomicAdd
//    returns, and the 2^32 units it lost are sent to the global grid, so a
//    cell's mass has no upper limit.  Integer adds commute, so the tile's
//    content does not depend on the order of the threads.
//  * A channel whose 3^3 stencil leaves the tile (a displacement beyond the
//    halo; H is set by the shared-memory budget, not by the data), or whose
//    masses are too large to convert, adds its 27 sums to the global grid
//    with float atomicAdds instead, so the result holds for any displacement.
//    A channel whose sub-particles would span more than 3 cells in float32
//    (positions beyond ~1e5 cells) deposits each sub-particle by itself with
//    8 global atomicAdds.
//  * R = 1..4 are compiled with the sub-particle loops unrolled; any other
//    integer R runs the same code with runtime loops.  At R = 1 (deposit onto
//    the hires grid itself) a channel is one particle, which a kernel of its
//    own (one thread per particle, 8 tile adds) serves without the stencil;
//    a brick then holds one particle per cell, so zeroing and flushing the
//    tile outweigh the deposit, and a wider halo only costs.
//  * Both tiles stay under the 48 KB of shared memory that a launch may take
//    without opting in (35 KB and 48.7 KB); a larger one would opt in once.
//
// Measured at 384^3 -> 128^3 on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py): 0.16 ms a call in a run of 50, with the zeroing of the
// output, and as much for the kernel alone in the profiler; 0.20-0.24 ms as
// the median of single calls, each timed by itself, which also holds the
// host's way to the launch.  The global-atomic kernel before it took 2.4 ms.
// What is left above the 0.078 ms of the bytes is the tile: zeroing, 27
// checked adds a channel and the flush, at 4 blocks of 256 threads an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;  // blocks per SM that the register budget is held to (64 a thread)

// Brick of channel cells per block and its halo (H cells below, H + 1 above):
// z fastest, so that a warp reads along a row.  At ratio 1 a cubic brick.
constexpr int BX = 8, BY = 8, BZ = 32, H = 3;
constexpr int B1 = 16;

struct Args {
    const float* hires;
    const float* dx;
    const float* dy;
    const float* dz;
    float* out;
    int nx, ny, nz, R;
    float d_init;
    // fixed-point tile: units per mass, mass per unit, the mass of 2^32 units
    // and the largest |value| a thread may convert
    float to_fixed, from_fixed, wrap_mass, fixed_limit;
};

__device__ __forceinline__ int wrap(int i, int n) {
    int r = i % n;
    return r < 0 ? r + n : r;
}

// wrap() for an index that mostly lies within one period of [0, n): spares
// the integer division.
__device__ __forceinline__ int wrap_near(int i, int n) {
    const int j = i < 0 ? i + n : (i >= n ? i - n : i);
    return (unsigned)j < (unsigned)n ? j : wrap(i, n);
}

// Add v to a cell of the global grid.  Said in PTX: behind a call that is not
// inlined the compiler no longer knows that `out` is global memory, and would
// give each atomicAdd a shared-memory branch with a compare-and-swap loop.
__device__ __forceinline__ void global_add(float* cell, float v) {
    asm volatile("red.global.add.f32 [%0], %1;" ::"l"(cell), "f"(v) : "memory");
}

// One sub-particle of mass m at (px, py, pz) straight into the global grid.
__device__ void deposit_global(float* out, int nx, int ny, int nz,
                               float px, float py, float pz, float m)
{
    const float flx = floorf(px), fly = floorf(py), flz = floorf(pz);
    const float fx = px - flx, fy = py - fly, fz = pz - flz;
    const int ix0 = wrap((int)flx, nx), iy0 = wrap((int)fly, ny), iz0 = wrap((int)flz, nz);
    const int xs[2] = {ix0, ix0 + 1 == nx ? 0 : ix0 + 1};
    const int ys[2] = {iy0, iy0 + 1 == ny ? 0 : iy0 + 1};
    const int zs[2] = {iz0, iz0 + 1 == nz ? 0 : iz0 + 1};
    const float wxs[2] = {1.0f - fx, fx};
    const float wys[2] = {1.0f - fy, fy};
    const float wzs[2] = {1.0f - fz, fz};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
            const int64_t base = ((int64_t)xs[a] * ny + ys[b]) * nz;
            const float mxy = m * wxs[a] * wys[b];
#pragma unroll
            for (int e = 0; e < 2; ++e) global_add(out + base + zs[e], mxy * wzs[e]);
        }
    }
}

// Hires index of residual s (0-based, s - R/2 centred) of channel c: the
// negative ones of c = 0 are the last hires cells of the axis.
__device__ __forceinline__ int hires_index(int c, int s, int R, int N) {
    const int h = R * c + s - R / 2;
    return h < 0 ? h + N : h;
}

// Every sub-particle of channel (cx, cy, cz), at q + s/R, straight into the
// global grid.
__device__ __noinline__ void deposit_channel_global(
    const Args& a, int R, int cx, int cy, int cz, float qx, float qy, float qz)
{
    const int NX = a.nx * R, NY = a.ny * R, NZ = a.nz * R;
    const float fR = (float)R;
    for (int sx = 0; sx < R; ++sx) {
        const int64_t hx = hires_index(cx, sx, R, NX);
        for (int sy = 0; sy < R; ++sy) {
            const float* row = a.hires + (hx * NY + hires_index(cy, sy, R, NY)) * NZ;
            for (int sz = 0; sz < R; ++sz) {
                const float m = 1.0f + __ldg(row + hires_index(cz, sz, R, NZ)) * a.d_init;
                deposit_global(a.out, a.nx, a.ny, a.nz,
                               qx + (float)(sx - R / 2) / fR,
                               qy + (float)(sy - R / 2) / fR,
                               qz + (float)(sz - R / 2) / fR, m);
            }
        }
    }
}

// The two CIC weights of a sub-particle at q + r on one axis, as a 3-vector
// over the cells base, base + 1, base + 2 (floor(q + r) is base or base + 1).
__device__ __forceinline__ void axis_weights(float q, float r, float base, float w[3]) {
    const float p = q + r;
    const float fl = floorf(p);
    const float f = p - fl;
    const bool up = fl != base;
    w[0] = up ? 0.0f : 1.0f - f;
    w[1] = up ? 1.0f - f : f;
    w[2] = up ? f : 0.0f;
}

// First cell (as a float) of a channel's stencil on one axis: the floor of
// its first sub-particle, at q + r_first.  `*spans_three` is cleared if the
// last one, at q + r_last, lies more than one cell further (float32 rounding
// at positions beyond ~1e5 cells, or NaN).
__device__ __forceinline__ float stencil_base(float q, float r_first, float r_last,
                                              bool* spans_three)
{
    const float base = floorf(q + r_first);
    if (!(floorf(q + r_last) - base <= 1.0f)) *spans_three = false;
    return base;
}

// Tile coordinate of a 3-cell stencil that starts at cell `base`, or -1 if it
// leaves the tile of `extent` cells that starts at cell `origin`.
__device__ __forceinline__ int tile_coordinate(float base, int origin, int extent) {
    const float t = base - (float)origin;
    return t >= 0.0f && t <= (float)(extent - 3) ? (int)t : -1;
}

// A block's shared-memory tile: the brick of SX x SY x SZ channel cells at
// (ox, oy, oz) plus its halo, as signed 32-bit integers in units of
// a.from_fixed.
template <int SX_, int SY_, int SZ_>
struct Tile {
    static constexpr int SX = SX_, SY = SY_, SZ = SZ_;
    static constexpr int TX = SX + 2 * H + 1, TY = SY + 2 * H + 1, TZ = SZ + 2 * H + 1;
    static constexpr int CELLS = TX * TY * TZ;
    static constexpr int BRICK = SX * SY * SZ;

    int* cells;
    const Args& a;
    int ox, oy, oz;

    __device__ void zero() {
        for (int i = threadIdx.x; i < CELLS; i += blockDim.x) cells[i] = 0;
        __syncthreads();
    }

    // The periodically wrapped global cell under tile cell i.
    __device__ float* global_cell(int i) const {
        const int gz = wrap_near(oz - H + i % TZ, a.nz);
        const int gy = wrap_near(oy - H + (i / TZ) % TY, a.ny);
        const int gx = wrap_near(ox - H + i / (TZ * TY), a.nx);
        return a.out + ((int64_t)gx * a.ny + gy) * a.nz + gz;
    }

    // Add v to tile cell i; |v| <= a.fixed_limit.
    __device__ __forceinline__ void add(int i, float v) {
        const unsigned q = (unsigned)__float2int_rn(v * a.to_fixed);
        const unsigned old = atomicAdd((unsigned*)cells + i, q);
        const unsigned now = old + q;
        // signed overflow: the cell wrapped by 2^32 units, which go to the global grid
        if ((int)((old ^ now) & (q ^ now)) < 0)
            global_add(global_cell(i), (int)q > 0 ? a.wrap_mass : -a.wrap_mass);
    }

    // One global atomicAdd per non-zero tile cell.
    __device__ void flush() {
        __syncthreads();
        for (int i = threadIdx.x; i < CELLS; i += blockDim.x) {
            if (cells[i] != 0) global_add(global_cell(i), (float)cells[i] * a.from_fixed);
        }
    }
};

// Level 2: one thread per channel cell, a 3x3x3 register stencil.
// RT is the ratio when compiled in (loops unrolled), 0 for a runtime ratio.
template <int RT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) cic_deposit_swept_kernel(const Args a)
{
    using T = Tile<BX, BY, BZ>;
    extern __shared__ int shared_cells[];
    const int R = RT > 0 ? RT : a.R;
    const int nx = a.nx, ny = a.ny, nz = a.nz;
    const int NX = nx * R, NY = ny * R, NZ = nz * R;
    const float fR = (float)R;
    const float r_first = (float)(-(R / 2)) / fR, r_last = (float)(R - 1 - R / 2) / fR;
    T tile = {shared_cells, a, (int)blockIdx.z * BX, (int)blockIdx.y * BY, (int)blockIdx.x * BZ};
    const int ox = tile.ox, oy = tile.oy, oz = tile.oz;

    tile.zero();
    for (int i = threadIdx.x; i < T::BRICK; i += blockDim.x) {
        const int cz = oz + i % BZ, cy = oy + (i / BZ) % BY, cx = ox + i / (BZ * BY);
        if (cx >= nx || cy >= ny || cz >= nz) continue;  // partial brick
        const int64_t c = ((int64_t)cx * ny + cy) * nz + cz;
        const float qx = (float)cx + __ldg(a.dx + c);
        const float qy = (float)cy + __ldg(a.dy + c);
        const float qz = (float)cz + __ldg(a.dz + c);
        bool spans_three = true;
        const float bx = stencil_base(qx, r_first, r_last, &spans_three);
        const float by = stencil_base(qy, r_first, r_last, &spans_three);
        const float bz = stencil_base(qz, r_first, r_last, &spans_three);
        if (!spans_three) {
            deposit_channel_global(a, R, cx, cy, cz, qx, qy, qz);
            continue;
        }

        float acc[3][3][3] = {};
        float m_abs = 0.0f;  // bounds every |acc|: the weights lie in [0, 1]
#pragma unroll
        for (int sx = 0; sx < R; ++sx) {
            const int64_t hx = hires_index(cx, sx, R, NX);
            float wx[3];
            axis_weights(qx, (float)(sx - R / 2) / fR, bx, wx);
            float ayz[3][3] = {};
#pragma unroll
            for (int sy = 0; sy < R; ++sy) {
                const float* row = a.hires + (hx * NY + hires_index(cy, sy, R, NY)) * NZ;
                float wy[3];
                axis_weights(qy, (float)(sy - R / 2) / fR, by, wy);
                float az[3] = {};
#pragma unroll
                for (int sz = 0; sz < R; ++sz) {
                    const float m = 1.0f + __ldg(row + hires_index(cz, sz, R, NZ)) * a.d_init;
                    m_abs += fabsf(m);
                    float wz[3];
                    axis_weights(qz, (float)(sz - R / 2) / fR, bz, wz);
#pragma unroll
                    for (int k = 0; k < 3; ++k) az[k] += m * wz[k];
                }
#pragma unroll
                for (int j = 0; j < 3; ++j) {
#pragma unroll
                    for (int k = 0; k < 3; ++k) ayz[j][k] += wy[j] * az[k];
                }
            }
#pragma unroll
            for (int i3 = 0; i3 < 3; ++i3) {
#pragma unroll
                for (int j = 0; j < 3; ++j) {
#pragma unroll
                    for (int k = 0; k < 3; ++k) acc[i3][j][k] += wx[i3] * ayz[j][k];
                }
            }
        }
        const int tx = tile_coordinate(bx, ox - H, T::TX);
        const int ty = tile_coordinate(by, oy - H, T::TY);
        const int tz = tile_coordinate(bz, oz - H, T::TZ);
        if (tx >= 0 && ty >= 0 && tz >= 0 && m_abs <= a.fixed_limit) {
            const int t0 = (tx * T::TY + ty) * T::TZ + tz;
#pragma unroll
            for (int i3 = 0; i3 < 3; ++i3) {
#pragma unroll
                for (int j = 0; j < 3; ++j) {
#pragma unroll
                    for (int k = 0; k < 3; ++k) {
                        if (acc[i3][j][k] != 0.0f)
                            tile.add(t0 + (i3 * T::TY + j) * T::TZ + k, acc[i3][j][k]);
                    }
                }
            }
        } else {
            // the stencil leaves the tile (or is too heavy for it): its 27
            // sums go to the global grid
            int gx[3], gy[3], gz[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                gx[k] = wrap((int)((unsigned)(int)bx + k), nx);
                gy[k] = wrap((int)((unsigned)(int)by + k), ny);
                gz[k] = wrap((int)((unsigned)(int)bz + k), nz);
            }
#pragma unroll
            for (int i3 = 0; i3 < 3; ++i3) {
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    float* row = a.out + ((int64_t)gx[i3] * ny + gy[j]) * nz;
#pragma unroll
                    for (int k = 0; k < 3; ++k) {
                        if (acc[i3][j][k] != 0.0f) global_add(row + gz[k], acc[i3][j][k]);
                    }
                }
            }
        }
    }
    tile.flush();
}

// Ratio 1 ("level 1"): one thread per particle of the brick (z fastest,
// coalesced reads), 8 tile adds where its 2x2x2 cells lie inside the tile.
__global__ void __launch_bounds__(THREADS) cic_deposit_ratio1_kernel(const Args a)
{
    using T = Tile<B1, B1, B1>;
    extern __shared__ int shared_cells[];
    const int nx = a.nx, ny = a.ny, nz = a.nz;
    T tile = {shared_cells, a, (int)blockIdx.z * B1, (int)blockIdx.y * B1, (int)blockIdx.x * B1};
    const int ox = tile.ox, oy = tile.oy, oz = tile.oz;

    tile.zero();
    for (int i = threadIdx.x; i < T::BRICK; i += blockDim.x) {
        const int cz = oz + i % B1, cy = oy + (i / B1) % B1, cx = ox + i / (B1 * B1);
        if (cx >= nx || cy >= ny || cz >= nz) continue;  // partial brick
        const int64_t c = ((int64_t)cx * ny + cy) * nz + cz;
        const float m = 1.0f + __ldg(a.hires + c) * a.d_init;
        const float px = (float)cx + __ldg(a.dx + c);
        const float py = (float)cy + __ldg(a.dy + c);
        const float pz = (float)cz + __ldg(a.dz + c);
        const float flx = floorf(px), fly = floorf(py), flz = floorf(pz);
        const float tx = flx - (float)(ox - H), ty = fly - (float)(oy - H), tz = flz - (float)(oz - H);
        const bool inside = tx >= 0.0f && tx <= (float)(T::TX - 2) && ty >= 0.0f
            && ty <= (float)(T::TY - 2) && tz >= 0.0f && tz <= (float)(T::TZ - 2)
            && fabsf(m) <= a.fixed_limit;
        if (!inside) {
            deposit_global(a.out, nx, ny, nz, px, py, pz, m);
            continue;
        }
        const float fx = px - flx, fy = py - fly, fz = pz - flz;
        const int t0 = ((int)tx * T::TY + (int)ty) * T::TZ + (int)tz;
        const float wxs[2] = {1.0f - fx, fx};
        const float wys[2] = {1.0f - fy, fy};
        const float wzs[2] = {1.0f - fz, fz};
#pragma unroll
        for (int i3 = 0; i3 < 2; ++i3) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
#pragma unroll
                for (int k = 0; k < 2; ++k)
                    tile.add(t0 + (i3 * T::TY + j) * T::TZ + k, m * wxs[i3] * wys[j] * wzs[k]);
            }
        }
    }
    tile.flush();
}

// Launch KERNEL, one block per brick of T.  Shared memory beyond 48 KB is
// opted into once per kernel.
template <void (*KERNEL)(const Args), class T>
int launch(const Args& a, cudaStream_t stream)
{
    constexpr int smem = T::CELLS * (int)sizeof(int);
    if constexpr (smem > 48 * 1024) {
        static const cudaError_t opted_in =
            cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (opted_in != cudaSuccess) return (int)opted_in;
    }
    const dim3 grid((a.nz + T::SZ - 1) / T::SZ, (a.ny + T::SY - 1) / T::SY,
                    (a.nx + T::SX - 1) / T::SX);
    KERNEL<<<grid, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// Zero `out` and launch the deposit, both on `stream`; `out` is (nx, ny, nz)
// float32, `hires` (R nx, R ny, R nz), the displacements (nx, ny, nz) in
// lowres cells, all contiguous on the device.  Returns the error of
// cudaMemsetAsync or cudaFuncSetAttribute, or else cudaGetLastError() after
// the launch.
extern "C" int cic_deposit_swept(
    const float* hires, const float* dx, const float* dy, const float* dz,
    float* out, int nx, int ny, int nz, int ratio, float d_init, void* stream)
{
    if (nx < 1 || ny < 1 || nz < 1 || ratio < 1) return (int)cudaErrorInvalidValue;
    // units of 2^-shift mass: the mean cell mass R^3 is at least 2^22 units,
    // and a tile cell holds +-2^31 of them before it wraps
    int shift = 23;
    for (int64_t r3 = (int64_t)ratio * ratio * ratio; r3 > 1 && shift > 0; r3 = (r3 + 1) / 2) --shift;
    const float to_fixed = (float)(1 << shift);
    const Args a = {hires, dx, dy, dz, out, nx, ny, nz, ratio, d_init,
                    to_fixed, 1.0f / to_fixed, 4294967296.0f / to_fixed, 2130706432.0f / to_fixed};
    cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)nx * ny * nz, s);
    if (err != cudaSuccess) return (int)err;
    switch (ratio) {
        case 1: return launch<cic_deposit_ratio1_kernel, Tile<B1, B1, B1>>(a, s);
        case 2: return launch<cic_deposit_swept_kernel<2>, Tile<BX, BY, BZ>>(a, s);
        case 3: return launch<cic_deposit_swept_kernel<3>, Tile<BX, BY, BZ>>(a, s);
        case 4: return launch<cic_deposit_swept_kernel<4>, Tile<BX, BY, BZ>>(a, s);
        default: return launch<cic_deposit_swept_kernel<0>, Tile<BX, BY, BZ>>(a, s);
    }
}
