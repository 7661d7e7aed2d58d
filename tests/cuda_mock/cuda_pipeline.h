// cp.async for the g++ mock of the CUDA runtime (cuda_runtime.h): a copy
// joins the thread's open group and lands when a wait covers that group.
#pragma once
#include "cuda_runtime.h"

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  cuda_mock::open_group.push_back({dst, src, n});
}
inline void __pipeline_commit() {
  cuda_mock::groups.push_back(std::move(cuda_mock::open_group));
  cuda_mock::open_group.clear();
}
// Land every committed group but the newest `n`.
inline void __pipeline_wait_prior(size_t n) {
  auto& g = cuda_mock::groups;
  while (g.size() > n) {
    for (const auto& c : g.front()) std::memcpy(c.dst, c.src, c.n);
    g.erase(g.begin());
  }
}
