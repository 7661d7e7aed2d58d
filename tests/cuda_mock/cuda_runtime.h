// A mock of the CUDA runtime for g++: runs a kernel of csrc/ on the CPU,
// one std::thread per CUDA thread, so that the tests can run the kernels'
// control flow, barriers, shuffles, cp.async ring and cross-block tickets
// on small shapes and hold them against their plain versions.  It models
// what the kernels rely on, not the card: every block's threads run at
// once and meet at real barriers; a shuffle is a write, a barrier of the
// warp, a read and a barrier; a cp.async copy lands only at the wait that
// covers its group (a read before that wait sees the 0xff fill of the
// dynamic shared memory, a NaN); blocks run one after another in a
// shuffled order, so any block of a reduction can be the last to arrive.
// Its floating point is the host's (glibc's expf), so bits differ from the
// card's; nothing here says anything about timing.  A cooperative launch
// (cudaLaunchKernelEx with cudaLaunchAttributeCooperative) runs every
// block's threads at once, as the card keeps every block of one resident,
// so a grid barrier (lstm_gates::grid_sync, cooperative_groups.h's
// this_grid().sync(): one barrier of every thread of the launch) meets
// there.
//
// tests/cuda_mock.py rewrites a source for it: each launch
// `k<<<grid, block, smem, stream>>>(args)` becomes
// `cuda_mock::launch(grid, block, smem, [&] { k(args); })` and
// `extern __shared__ T name[];` a pointer to the block's dynamic shared
// memory.  Compile with g++ -std=c++20 -pthread -ffp-contract=off.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct float4 {
  float x, y, z, w;
};
struct uint4 {
  unsigned x, y, z, w;
};
struct uint2 {
  unsigned x, y;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaLaunchAttributeID { cudaLaunchAttributeCooperative = 2 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union {
    int cooperative;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes = 0;
  cudaStream_t stream = nullptr;
  cudaLaunchAttribute* attrs = nullptr;
  unsigned numAttrs = 0;
};
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
enum { cudaSharedmemCarveoutMaxShared = 100 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// One block an SM: the mock runs blocks one after another.
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "invalid argument (mock)" : "no error (mock)";
}

inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __expf(float x) { return std::exp(x); }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
using std::max;
using std::min;

namespace cuda_mock {

// One block's meeting points, shared by its threads.
struct Block {
  explicit Block(int n) : all(n) {
    int warps = (n + 31) / 32;
    for (int w = 0; w < warps; ++w)
      warp.emplace_back(std::make_unique<std::barrier<>>(
          std::min(32, n - 32 * w)));
    slots.assign((size_t)warps * 32, 0);
  }
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<uint64_t> slots;
  std::mutex named_lock;
  std::map<int, std::unique_ptr<std::barrier<>>> named;
};

struct Copy {
  void* dst;
  const void* src;
  size_t n;
};

inline thread_local Block* block = nullptr;
// every thread of the cooperative launch running, else null
inline thread_local std::barrier<>* coresident = nullptr;
inline thread_local unsigned char* dyn_smem = nullptr;
inline thread_local std::vector<std::vector<Copy>> groups;
inline thread_local std::vector<Copy> open_group;

template <class F>
void launch(dim3 grid, dim3 threads, size_t smem, F kernel);
template <class F>
void launch_coresident(dim3 grid, dim3 threads, size_t smem, F kernel);

}  // namespace cuda_mock

// cudaLaunchKernelEx: cooperative launches run every block at once, others
// as a <<<>>> launch does.
template <class... Exp, class... Act>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                                      void (*kernel)(Exp...),
                                      Act&&... args) {
  bool coop = false;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    coop |= cfg->attrs[i].id == cudaLaunchAttributeCooperative &&
            cfg->attrs[i].val.cooperative != 0;
  auto body = [&] { kernel(args...); };
  if (coop)
    cuda_mock::launch_coresident(cfg->gridDim, cfg->blockDim,
                                 cfg->dynamicSmemBytes, body);
  else
    cuda_mock::launch(cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes,
                      body);
  return cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

inline void __syncthreads() { cuda_mock::block->all.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  cuda_mock::block->warp[threadIdx.x / 32]->arrive_and_wait();
}
// bar.sync id, n: the first `n` threads to arrive at barrier `id` meet.
inline void cuda_mock_named_sync(int id, int n) {
  cuda_mock::Block* b = cuda_mock::block;
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> g(b->named_lock);
    auto& slot = b->named[id];
    if (!slot) slot = std::make_unique<std::barrier<>>(n);
    bar = slot.get();
  }
  bar->arrive_and_wait();
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
template <class T>
inline T __ldcg(const T* p) {
  T v;
  __atomic_load(p, &v, __ATOMIC_SEQ_CST);
  return v;
}
inline float4 __ldcg(const float4* p) {
  std::atomic_thread_fence(std::memory_order_seq_cst);
  float4 v;
  std::memcpy(&v, p, sizeof v);
  return v;
}

namespace cuda_mock {
template <class T>
T exchange(T v, int src_lane) {
  static_assert(sizeof(T) <= 8, "a shuffle moves at most 8 bytes");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  block->slots[warp * 32 + lane] = bits;
  block->warp[warp]->arrive_and_wait();
  bits = block->slots[warp * 32 + src_lane];
  block->warp[warp]->arrive_and_wait();
  T out;
  std::memcpy(&out, &bits, sizeof(T));
  return out;
}
}  // namespace cuda_mock

template <class T>
T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int lane = threadIdx.x % 32;
  return cuda_mock::exchange(v, (lane & ~(width - 1)) + (src % width));
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int mask, int width = 32) {
  return cuda_mock::exchange(v, (threadIdx.x % 32) ^ mask);
}

namespace cuda_mock {

template <class F>
void launch(dim3 grid, dim3 threads, size_t smem, F kernel) {
  const int n = (int)(threads.x * threads.y * threads.z);
  std::vector<dim3> order;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) order.push_back(dim3(x, y, z));
  static std::mt19937 rng(12345);
  std::shuffle(order.begin(), order.end(), rng);
  for (const dim3& b : order) {
    Block blk(n);
    std::vector<unsigned char> shared(smem + 16, 0xff);
    unsigned char* base = shared.data();
    base += (16 - reinterpret_cast<uintptr_t>(base) % 16) % 16;
    std::vector<std::thread> pool;
    for (int t = 0; t < n; ++t)
      pool.emplace_back([&, t] {
        block = &blk;
        dyn_smem = base;
        groups.clear();
        open_group.clear();
        threadIdx = dim3(t % threads.x, t / threads.x % threads.y,
                         t / (threads.x * threads.y));
        blockIdx = b;
        blockDim = threads;
        gridDim = grid;
        kernel();
      });
    for (auto& th : pool) th.join();
  }
}

// Every block's threads at once, each block with its own meeting points
// and its own 0xff-filled dynamic shared memory, all of them meeting at
// the grid barrier.
template <class F>
void launch_coresident(dim3 grid, dim3 threads, size_t smem, F kernel) {
  const int n = (int)(threads.x * threads.y * threads.z);
  std::vector<dim3> order;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) order.push_back(dim3(x, y, z));
  std::vector<std::unique_ptr<Block>> blocks;
  std::vector<std::vector<unsigned char>> shared;
  for (size_t i = 0; i < order.size(); ++i) {
    blocks.emplace_back(std::make_unique<Block>(n));
    shared.emplace_back(smem + 16, 0xff);
  }
  std::barrier<> all((std::ptrdiff_t)(order.size() * n));
  std::vector<std::thread> pool;
  for (size_t k = 0; k < order.size(); ++k) {
    unsigned char* base = shared[k].data();
    base += (16 - reinterpret_cast<uintptr_t>(base) % 16) % 16;
    for (int t = 0; t < n; ++t)
      pool.emplace_back([&, k, base, t] {
        block = blocks[k].get();
        coresident = &all;
        dyn_smem = base;
        groups.clear();
        open_group.clear();
        threadIdx = dim3(t % threads.x, t / threads.x % threads.y,
                         t / (threads.x * threads.y));
        blockIdx = order[k];
        blockDim = threads;
        gridDim = grid;
        kernel();
      });
  }
  for (auto& th : pool) th.join();
}

}  // namespace cuda_mock
