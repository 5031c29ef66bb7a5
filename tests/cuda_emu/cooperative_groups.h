// The cluster part of cooperative_groups for the CPU emulation in
// cuda_runtime.h beside this file.
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {
struct cluster_group {
    void sync() const { emu::cluster->bar->arrive_and_wait(); }
    unsigned block_rank() const { return emu::rank; }
    unsigned num_blocks() const { return (unsigned)emu::cluster->blocks.size(); }
    template <class T> T* map_shared_rank(T* p, unsigned r) const {
        const auto off = reinterpret_cast<char*>(p) -
                         reinterpret_cast<char*>(emu::block->smem.data());
        return reinterpret_cast<T*>(
            reinterpret_cast<char*>(emu::cluster->blocks[r]->smem.data()) + off);
    }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
