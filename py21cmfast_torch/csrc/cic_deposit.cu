// Swept 2LPT cloud-in-cell deposit for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel py21cmfast_tpu/ops/pallas_deposit.py::_deposit_kernel
// (the dense factored pass entered through pallas_factored_deposit) together
// with its exact outlier pass, outlier_scatter_from_stack: it computes the
// result of models/perturb.py::_pallas_deposit, not the TPU's block layout.
//
// Work: one thread per hires cell h (grid-stride loop, 64-bit linear index,
// z fastest so the hires reads coalesce).  On each axis the hires index
// decomposes into the lowres channel cell c = ((h + R/2) / R) mod n and the
// centred sub-cell residual s = (h + R/2) mod R - R/2 (ops/deposit.py
// `_chan`: the last partial channel wraps to c = 0).  The sub-particle has
// mass m = 1 + delta_h * D_init and lands at p = c + d(c) + s/R in lowres
// cells, where d is the lowres displacement field; its eight trilinear
// weights are added atomically into the zeroed lowres grid with periodic
// wrap.  Every particle is deposited exactly, so there is no support limit,
// no mask and no outlier pass.
//
// Bound: the kernel reads DIM^3 floats of hires density (each once) and the
// three lowres displacement grids (each value shared by R^3 threads, served
// from cache), and issues 8 * DIM^3 float atomics into a lowres grid that
// stays resident in the 50 MB L2 (8 MB at 128^3).  Bytes alone give a bound
// of 78 us at 384^3 -> 128^3 (260 MB at 3.35 TB/s); the 4.5e8 atomics, many
// of them to the same few addresses within a warp, bound it instead: it
// measured 2.4 ms there on an H100 80GB HBM3 at 700 W (PERF.md).  A later
// revision can privatize a lowres tile per block in shared memory and flush
// it with one atomic per cell.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
    int r = i % n;
    return r < 0 ? r + n : r;
}

__global__ void cic_deposit_swept_kernel(
    const float* __restrict__ hires,
    const float* __restrict__ dx,
    const float* __restrict__ dy,
    const float* __restrict__ dz,
    float* __restrict__ out,
    int nx, int ny, int nz, int R, float d_init)
{
    const int64_t NY = (int64_t)ny * R;
    const int64_t NZ = (int64_t)nz * R;
    const int64_t total = (int64_t)nx * R * NY * NZ;
    const int half = R / 2;
    const float fR = (float)R;

    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += (int64_t)gridDim.x * blockDim.x) {
        const int64_t hz = i % NZ;
        const int64_t t = i / NZ;
        const int64_t hy = t % NY;
        const int64_t hx = t / NY;

        // channel decomposition per axis: h + R/2 = R*c + (s + R/2)
        const int ax = (int)(hx + half), ay = (int)(hy + half), az = (int)(hz + half);
        int cx = ax / R, cy = ay / R, cz = az / R;
        const int sx = ax - cx * R - half, sy = ay - cy * R - half, sz = az - cz * R - half;
        if (cx == nx) cx = 0;
        if (cy == ny) cy = 0;
        if (cz == nz) cz = 0;
        const int64_t c = ((int64_t)cx * ny + cy) * nz + cz;

        const float px = (float)cx + __ldg(dx + c) + (float)sx / fR;
        const float py = (float)cy + __ldg(dy + c) + (float)sy / fR;
        const float pz = (float)cz + __ldg(dz + c) + (float)sz / fR;
        const float m = 1.0f + __ldg(hires + i) * d_init;

        const float flx = floorf(px), fly = floorf(py), flz = floorf(pz);
        const float fx = px - flx, fy = py - fly, fz = pz - flz;
        const int ix0 = wrap((int)flx, nx), iy0 = wrap((int)fly, ny), iz0 = wrap((int)flz, nz);
        const int ix1 = ix0 + 1 == nx ? 0 : ix0 + 1;
        const int iy1 = iy0 + 1 == ny ? 0 : iy0 + 1;
        const int iz1 = iz0 + 1 == nz ? 0 : iz0 + 1;

        const int xs[2] = {ix0, ix1};
        const int ys[2] = {iy0, iy1};
        const int zs[2] = {iz0, iz1};
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
                for (int e = 0; e < 2; ++e) {
                    atomicAdd(out + base + zs[e], mxy * wzs[e]);
                }
            }
        }
    }
}

}  // namespace

// Launch on `stream`; `out` must be zeroed (nx, ny, nz) float32, `hires`
// (R nx, R ny, R nz), the displacements (nx, ny, nz) in lowres cells, all
// contiguous on the device.  Returns cudaGetLastError() after the launch.
extern "C" int cic_deposit_swept(
    const float* hires, const float* dx, const float* dy, const float* dz,
    float* out, int nx, int ny, int nz, int ratio, float d_init, void* stream)
{
    const int threads = 256;
    const int64_t total = (int64_t)nx * ny * nz * ratio * ratio * ratio;
    int64_t blocks = (total + threads - 1) / threads;
    int device = 0, n_sm = 132;
    if (cudaGetDevice(&device) == cudaSuccess)
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    const int64_t max_blocks = (int64_t)n_sm * 64;  // grid-stride beyond 64 blocks per SM
    if (blocks > max_blocks) blocks = max_blocks;
    if (blocks < 1) blocks = 1;
    cic_deposit_swept_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        hires, dx, dy, dz, out, nx, ny, nz, ratio, d_init);
    return (int)cudaGetLastError();
}
