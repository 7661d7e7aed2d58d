// The mock's cooperative_groups: this_grid().sync() is a barrier of every
// thread of a cooperative launch (cuda_runtime.h's launch_coresident runs
// every block's threads at once); outside one it aborts, as a grid sync
// outside a cooperative launch is undefined on the card.
#pragma once

#include <cstdio>
#include <cstdlib>

#include "cuda_runtime.h"

namespace cooperative_groups {

struct grid_group {
  void sync() const {
    if (cuda_mock::coresident == nullptr) {
      std::fprintf(stderr, "grid sync outside a cooperative launch\n");
      std::abort();
    }
    cuda_mock::coresident->arrive_and_wait();
  }
};

inline grid_group this_grid() { return {}; }

}  // namespace cooperative_groups
