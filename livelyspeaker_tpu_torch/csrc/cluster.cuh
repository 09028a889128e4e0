// Thread-block cluster helpers shared by K1 and K2 (through
// transmlp_common.cuh) and K3 (fused_wav.cu): the cluster barrier in its
// two halves, and the launch configuration of a 1-D grid of clusters.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

// cg::this_cluster().sync() in its two halves: work that touches no other
// CTA's shared memory can stand between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// `groups` clusters of `cluster` CTAs of `threads` threads in a 1-D grid,
// `smem` bytes of dynamic shared memory a CTA; the caller sets the stream.
inline void cluster_launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int threads,
                                  int groups, int cluster, size_t smem) {
  *cfg = {};
  cfg->gridDim = dim3((unsigned)(groups * cluster), 1, 1);
  cfg->blockDim = dim3((unsigned)threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace
