// The grid group of the host emulation (cuda_runtime.h): this_grid().sync()
// is the cooperative launch's grid barrier.
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {
struct grid_group {
  void sync() const { kt_grid_sync(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
