// Tile sizes of the GLU feed-forward kernel (glu_ff.cu).
//
// The launch planner in tone_tpu_torch/ops/glu_ff.py (`plan_glu_ff`) reads
// the same numbers from this file, so the tile and the depth split it
// chooses are those the kernel walks.  Keep one `constexpr int NAME = value;`
// per line: the planner parses exactly that.
//
// One template, two tiles: a block of (BM / (16 * MT)) x WN warps computes
// BM rows x BN columns of y over one depth slice of F, BK deep per
// cp.async stage; each warp owns 16 * MT rows x BN / WN columns.  The
// numbers are the fastest a sweep of tile shapes found on an H100.

#pragma once

constexpr int GF_SMALL_BM = 32;          // small tile (every M below GF_BIG_MIN_ROWS): rows
constexpr int GF_SMALL_BN = 128;         //   output columns
constexpr int GF_SMALL_BK = 64;          //   depth of one stage
constexpr int GF_SMALL_WN = 4;           //   warps across the columns
constexpr int GF_SMALL_MT = 2;           //   16-row mma tiles per warp
constexpr int GF_SMALL_STAGES = 4;       //   stages in the cp.async ring
constexpr int GF_BIG_BM = 64;            // big tile (M >= GF_BIG_MIN_ROWS): rows
constexpr int GF_BIG_BN = 128;           //   output columns
constexpr int GF_BIG_BK = 32;            //   depth of one stage
constexpr int GF_BIG_WN = 4;             //   warps across the columns
constexpr int GF_BIG_MT = 2;             //   16-row mma tiles per warp
constexpr int GF_BIG_STAGES = 5;         //   stages in the cp.async ring
constexpr int GF_BIG_MIN_ROWS = 1024;    // rows from which the big tile is used
constexpr int GF_MAX_SPLIT = 8;          // most depth slices of F (a power of two): a
                                         // tile's slices are one cluster, 8 at most
