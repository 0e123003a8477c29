// Tile sizes of the fused-layer kernel (fused_layer.cu).
//
// The launch planner in tone_tpu_torch/ops/fused_layer.py (`plan_launch`)
// reads the same numbers from this file, so the grid, the tile counts and
// the scratch layout it computes are those the kernel walks.  Keep one
// `constexpr int NAME = value;` per line: the planner parses exactly that.

#pragma once

constexpr int FL_THREADS = 256;          // threads per block: 8 warps
constexpr int FL_BM = 64;                // rows of a matmul tile (several streams)
constexpr int FL_BN_FF = 64;             // output columns of a feed-forward tile
constexpr int FL_BN = 32;                // output columns of the other projections' tiles
constexpr int FL_FF_SPLIT = 4;           // most depth splits of the FF down projection
constexpr int FL_BK = 64;                // depth of one cp.async stage
constexpr int FL_STAGES = 4;             // stages in the cp.async ring
constexpr int FL_CONV_COLS = 128;        // channels of one depthwise-conv item
constexpr int FL_SMEM = 110592;          // dynamic shared memory per block (bytes)
constexpr int FL_MAX_BLOCKS_PER_SM = 2;  // __launch_bounds__ minimum blocks per SM
constexpr int FL_SCRATCH_ALIGN = 256;    // byte alignment of each scratch buffer
constexpr int FL_MAX_D = 512;            // d_model limit (a norm row in registers)
constexpr int FL_MAX_TKV = 64;           // keys per query: two per lane in the softmax
constexpr int FL_MAX_DH = 64;            // head width: two features per lane
