// Fused cosine-sim attention backward for Hopper (sm_90a): three kernels.
//
// Replaces the TPU kernels of flash_cosine_sim_attention_tpu/ops/bwd_kernel.py:
//   fcsa_bwd_onepass  K2   `_fused_bwd_kernel_t`  dQ, dK, dV in one sweep
//   fcsa_bwd_dq       K3a  `_dq_kernel_t`         dQ, and dB summed over the
//                                                 bias's shared axis
//   fcsa_bwd_dkdv     K3b  `_dkdv_kernel_t`       dK, dV
// K2 and K3b share one template (dkdv_mma_kernel for bf16 on the tensor
// cores, dkdv_tf32_kernel for f32 on them as 3xTF32 split products, at
// every width up to 256); K2 adds the dQ sweep.  K3a is dq_mma_kernel
// (bf16) and dq_tf32_kernel (f32, 3xTF32, up to d 256).  Past d 256 all
// three take the wide route's kernels (below).
//
// Maths (the JAX forward's convention: no row max, no "- scale" shift).
// The wrapper hands in dO' = dO * inv_l (rounded back to dO's dtype) and
// delta' = rowsum(dO * O) * inv_l in f32, so P = e * inv_l never forms:
//     e   = exp2(log2e * (scale * q.k + bias))
//     dP' = dO' . v^T
//     dS  = e * (dP' - delta')
//     dV += e^T dO'          dK += scale * dS^T q
//     dQ += scale * dS k     dB += dS (no scale)
// An entry that is out of range, causally hidden or key-masked contributes
// exactly 0: its e and dS are selected to 0 and never computed, and every
// out-of-range row of a tile loads as 0, so no garbage reaches a sum.
//
// Ownership on a card whose blocks run in parallel and in no order:
// - the dK/dV kernels (K2 and K3b): one block per (batch, kv head, 64
//   keys) owns its dK, dV rows in registers and loops over the kv head's
//   whole query-head group and the q tiles that can see its keys, so
//   GQA/MQA need no atomics and no per-query-head outputs.  K2 (DQ = true)
//   also forms dS . K for each q tile and adds it to an f32 (B, H, seq_q,
//   d) scratch with atomics, as the original CUDA kernel did; the TPU
//   kernel avoided atomics by keeping the whole q extent resident in VMEM,
//   which does not fit in 227 KB of shared memory.  The wrapper zeroes the
//   scratch and scales and casts it afterwards.  The atomics' order varies
//   from run to run.  Nor does K2 need a cap on seq_q, and bf16 up to d
//   256 takes it at every length (ops/blocks.py onepass_backward): at
//   the long-context training shape (b4 h8 s16384 d64 causal) the
//   scratch is 134 MB, past the 50 MB L2, but a wave of blocks (key
//   tiles slowest, low keys first, each sweeping its q tiles upward)
//   adds into q rows near one another, and K2 took 16.6 ms a call on an
//   H100 against 32.0 ms for K3a + K3b, which form S and dP' twice and
//   stream Q, K, V and dO' twice.
// - the dQ kernels (K3a): one block per (batch, head, 64 queries) owns its
//   dQ rows and loops over the keys they can see.  With a bias it adds
//   each dS entry to an f32 (B|H, seq_q, seq_k) dB scratch with atomics:
//   the shared axis (batch for an (h, i, j) bias, heads for a (b, i, j)
//   one) is summed by the blocks that share a bias slice, so there is no
//   cap on its length (the TPU kernel capped it at 16 for VMEM).
//
// Bound on the H100 at the trainer's shape (b4 h8 s1024 d64 causal bf16):
// K2's maths is 5 products of 2d FLOPs per visible (i, j) pair, ~10.7 GFLOP,
// ~10.9 us at the bf16 tensor-core rate, against ~34 MB of bf16 q, k, v,
// dO', dK, dV plus delta' and the f32 dQ scratch (~10 us at 3.35 TB/s):
// operations bound.  Beside both, K2's dQ adds are ~17.8 M f32 reductions
// (136 visible 64 x 64 tile pairs per head, 64 x 64 each) into an 8.4 MB
// scratch that stays in the 50 MB L2.  K3b (with an (h, i, j) bias) does
// 4 of the products and reads the visible half of the f32 bias (~17 MB).
// K3a does 3 (S, dP', dQ: ~6.4 GFLOP, ~6.5 us) and reads the same bias and
// adds dS into dB (~17 MB, 8.4 M float2 adds), so it is bytes bound.
// In float32 the 3xTF32 K2 does three times K2's operations at the TF32
// rate (495 TFLOP/s): ~65 us, against ~18 us for its ~59 MB; the 3xTF32
// K3a and K3b ~39 and ~52 us, against ~23 and ~20 us of bytes with the
// (h, i, j) bias.  The heads-256 model's shape (b4 h2 s1024 d256 causal)
// has the same b x h x d, so the same operations: K2 f32 ~65 us on the
// TF32 tensor cores (~160 us at the FMA rate, 67 TFLOP/s), K3a and K3b
// ~39 and ~52 us.
//
// bfloat16 inputs run the tensor-core kernel `dkdv_mma_kernel`, the
// FlashAttention-2 backward reshaped for this op (no row max, JAX's exp2
// convention, the prescaled dO' and delta').  4 warps of 128 threads, each
// warp owning 16 of the block's 64 keys (above d 128, 8 warps: see below).  K and V arrive once by cp.async
// and stay in shared memory: their A fragments are read by ldmatrix per q
// tile, since in registers they would cost 64 more at d 128 beside dK's
// and dV's 128 accumulators.  Q, dO' and delta' tiles (64 queries; 32
// above d 64 and 16 for K3b at d 128, which keeps the S tiles and the
// accumulators within 255 registers) stream through a double-buffered
// cp.async ring.  Per tile:
// S^T = K.Q^T and dP^T = V.dO'^T by mma.sync m16n8k16 with f32 sums;
// e^T = exp2(c s + bias log2e), hidden entries selected to exact 0 (the
// masks are skipped on tiles every pair of which is visible);
// dS^T = e^T (dP^T - delta'); then dV += e^T.dO' and dK += dS^T.Q, the C
// fragments of e^T and dS^T turned into A fragments in registers, dO' and
// Q read by ldmatrix.trans.  K2 then stages dS^T in shared memory, and
// after a barrier each warp forms 16 query rows of dS.K (all d, or half
// of d at the 32-query tiles) and adds them to the scratch with float2
// atomics (red.global.add.v2.f32).  K3b stages each tile's bias (64 keys
// of BQ query rows, f32) through the same cp.async ring, so tiles that
// every pair of sees whole skip the masks with a bias too.  Causal blocks
// run heaviest first: key tiles are the grid's slowest axis, low keys
// (seen by the most queries) first.
//
// e and dS enter the dV, dK and dQ products as two bf16 operands each, hi
// = bf16(x) and lo = bf16(x - hi), so the products see them to ~16 bits
// (8 products of 2d FLOPs per visible pair for K2 instead of 5).  The JAX
// kernels round them to bf16 once; on the card that moves a gradient entry
// by up to a bf16 ulp of its largest term, and for the early keys of a
// causal row (a few large terms that cancel) that broke the 2^-7 of
// |g| + rms(g) bar against the f32 plain version (on an H100: 0.0195 on dV
// at b1 h8/2 s1024 d128; the plain version itself moves 0.0104 when the
// scale moves by 2^-21).
//
// Above d 128 (the 192 and 256 instances) a warp cannot hold both dK and
// dV of its 16 keys: 2 x 16 x d f32 is d registers a thread, 256 at d 256.
// So a block has 8 warps, two for each 16 keys: the first forms S, e and
// dV += e^T.dO', the second S, dP, e, dS and dK += dS^T.Q (and K2's dS^T
// staging).  S is formed twice (one more product of 2d FLOPs per visible
// pair), against a second pass over every Q and dO' tile, which would
// form S twice as well and read the tiles twice.  All 8 warps share K2's
// dQ products.  Query tiles are 32 rows at d 192 and 16 at d 256.
//
// K3a on bfloat16 runs the tensor-core kernel `dq_mma_kernel`, the
// FlashAttention-2 dQ kernel for this op: 4 warps of 128 threads own 64
// queries, 16 a warp.  Q and dO' arrive once by cp.async and stay in
// shared memory (their A fragments held in registers up to d 64, read by
// ldmatrix at every key tile above); delta' stays in registers.  K, V
// and, with a bias, the (64 queries x keys) f32 bias tile stream through a
// double-buffered cp.async ring, 64 keys a tile (32 above d 128, where
// dQ's accumulators are d / 2 registers a thread).  Per tile:
// S = Q.K^T and dP' = dO'.V^T by mma.sync, e and dS in registers (the
// masks skipped on whole tiles), dS added to dB by float2 atomics
// (red.global.add.v2.f32) before any rounding, and dQ += dS.K with dS's
// C fragments re-packed as A fragments (hi + lo, as in the dK/dV kernel)
// and K read by ldmatrix.trans; dQ is scaled once, at the store.  Causal
// key loops stop at the block's last diagonal, and query tiles run
// heaviest first.
//
// Past d 256 (the wide route) no warp holds a row's dK, dV or dQ
// accumulators, so the wrapper pads d to a multiple of 128 (ops/blocks.py
// WIDE_CHUNK) and the output columns become a grid axis.  Bound: at the
// heads-512 training shape (b4 h1 s1024 d512 causal bf16) K2's products
// are ~10.7 GFLOP (~11 us at the bf16 rate), operations-bound on paper;
// what bounds this design is mma.sync's issue rate, the hi + lo products
// and the S and dP' each column block forms again.
// - bf16 K2 and K3b run on the tensor cores (`dkdv_wide_mma_kernel<DQ>`):
//   a block of 8 warps owns 64 keys and 256 columns of dK and dV (16 keys
//   x 256 f32 are 128 registers a thread; at d 384 or 1152 the last block
//   owns a 128-column remainder), so S^T and dP^T are formed ceil(d / 256)
//   times, twice at d 512, with 128 blocks in flight at that shape.  Per
//   tile of 32 queries K, V, Q and dO' stream in 256-byte row chunks
//   through a double-buffered cp.async ring, and warps 0-3 sum S^T =
//   K.Q^T, warps 4-7 dP^T = V.dO'^T over them, each once: warps 0-3 form
//   e^T and hand it to warps 4-7 through shared memory (in C-fragment
//   order, so each lane reads its own entries), which form dS^T.  Then
//   dV += e^T.dO'[:, cols] (warps 0-3) and dK += dS^T.Q[:, cols] (warps
//   4-7), from the tile's Q and dO' column tiles (double-buffered, loaded
//   with its first chunk), e and dS as bf16 hi + lo as in dkdv_mma_kernel.
//   K2 stages dS^T and all 8 warps add dS.K[:, cols] (K's column tile
//   stays resident) to the dQ scratch's own columns with float2 atomics.
//   K3b stages the bias tile with the first chunk.  Shared memory: 219 KB
//   (K2) and 193 KB (K3b with a bias) at every d.
// - bf16 K3a runs on the tensor cores (`dq_wide_mma_kernel`), the same
//   design turned around: a block of 8 warps owns 64 queries and 256 dQ
//   columns (a 128-column remainder at d 384 or 1152), so S and dP' are
//   formed ceil(d / 256) times.  Per tile of 64 keys Q, dO', K and V
//   stream in 256-byte row chunks through a double-buffered cp.async
//   ring; warps 0-3 sum S = Q.K^T, warps 4-7 dP' = dO'.V^T over them,
//   16 queries a warp.  Warps 0-3 form e and hand it to warps 4-7 through
//   shared memory (C-fragment order); those form dS, add it to dB by float2
//   atomics before any rounding (column block 0 alone, else dB would be
//   counted once a column block) and hand it back over e.  Then each warp
//   adds dQ[:, its 128 columns] += dS.K[:, those columns], dS as bf16 hi +
//   lo, K's column tile (with the bias tile) loaded with the key tile's
//   last chunk.  dQ is scaled once, at the store; causal key loops stop at
//   the block's last diagonal, and query tiles run heaviest first.  Shared
//   memory: 185 KB, 203 KB with a bias, at every d.
// - f32 K2 runs on the tensor cores as 3xTF32 (`dkdv_wide_tf32_kernel<true>`):
//   a block owns 32 keys and 256 columns of dK and dV (a 128-column
//   remainder at d 384 or 1152) and walks 32-query tiles.  8 warps: for
//   each 16 keys a dV pair and a dK pair.  The dV pair forms S^T, e^T and
//   dV += e^T.dO'[:, cols], the dK pair dP^T, dS^T and dK +=
//   dS^T.Q[:, cols]; each warp of a pair sums S^T or dP^T over its half of
//   every chunk (the two halves added through shared memory once a tile,
//   in the same order by both) and forms its product over its half of the
//   block's columns (128 f32 a row, 64 registers a thread).  e^T goes
//   from the dV pair to the dK pair through shared memory (lane for
//   lane), dS^T to a staging tile, and all eight warps add dS.K[:, cols]
//   to the dQ scratch's own columns by float2 red adds.  Per tile K, V, Q
//   and dO' stream in 64-lane chunks through a 3-stage cp.async ring, the
//   block's own columns last: their Q and dO' chunks land in the column
//   tiles that the products read, so no column is loaded twice.  The
//   kernel is bound by those streams (the L2's rate), not by its
//   products: the bf16 kernel's shape (64 keys, 32-query tiles) does not
//   fit in f32, 16-query tiles re-read K and V twice as often (1.12 ms at
//   b4 h1 s1024 d512 causal on an H100; 16 keys x 256 columns in one
//   warp, the d 256 instance's layout, spilled 2.7 KB besides), and this
//   shape takes 0.86 ms.  Each operand is split as its fragment is read (a
//   warp's K or V rows are its own; two warps read each Q, dO' and K
//   column word; no lo tiles fit beside the ring).  S^T and dP^T sum in
//   four accumulators (hi.hi and the small terms apart, each by the k
//   step's parity), as the d 256 instance's, closed every chunk into a
//   running sum added to nearest (dS = e (dP - delta) takes the
//   difference of two large sums of one sign, and over d 512 the longer
//   chains of sums rounded toward zero put dq at 9.8e-5 of max|g| over
//   8192 mean-3 keys).  dK and dV chains close
//   every 256 queries into the block's own rows and columns in global
//   memory.  S^T and dP^T are formed ceil(d / 256) times, twice at d 512,
//   with 256 blocks at that shape.  Shared memory: 225 KB at every d.
//   Bound at the heads-512 training shape (b4 h1 s1024 d512 causal): 3 x
//   10.7 GFLOP on the TF32 tensor cores, 0.065 ms at 495 TFLOP/s (at the
//   FMA rate, 67 TFLOP/s, 0.160 ms).
// - f32 K3b is the same kernel without dQ (`dkdv_wide_tf32_kernel<false>`):
//   no K column tile, no dS staging, no red adds; the bias tile (32
//   queries x 32 keys, f32) comes through the ring with a tile's first
//   chunk (double-buffered, as delta') and the dV warps add it to S^T in
//   f32, never split, before exp2.  Shared memory: 188 KB, 197 KB with a
//   bias.  Bound at the heads-512 shape with an (h, i, j) bias: 3 x 8.6
//   GFLOP, 0.052 ms at 495 TFLOP/s.
// - f32 K3a runs on the tensor cores as 3xTF32 (`dq_wide_tf32_kernel`), the
//   bf16 K3a's design in K2's f32 streams: a block of 8 warps owns 64
//   queries and 256 dQ columns (a 128-column remainder at d 384 or 1152)
//   and walks 32-key tiles.  Warps 0-3 sum S = Q.K^T, warps 4-7 dP' =
//   dO'.V^T, 16 queries a warp over whole chunks (Q's and dO''s rows are
//   read by one warp each), in four accumulators closed every chunk as
//   K2's.  Warps 0-3 form e (the bias added in f32), hand it to the dP'
//   warp of their queries through shared memory (C-fragment order, a
//   named barrier a pair), which forms dS, adds it to dB by float2 red
//   adds before any rounding (column block 0 alone) and hands it back
//   over e.  Then each warp adds dQ[:, its 128 columns] += dS.K[:, those
//   columns], dS split in registers, K's column tile split as it is read.
//   Per tile Q, dO', K and V stream in 64-lane chunks through a 3-stage
//   cp.async ring, the block's own columns last: their K chunks land in
//   the column tile the product reads.  dQ's chains close every 256 keys
//   into the thread's own dQ words in global memory, as dq_tf32_kernel's
//   above d 128; dQ is scaled there.  64 queries halve how often K and V
//   stream against K2's 32 (a block forms 64 x 32 pairs for 192 streamed
//   rows, K2 32 x 32 for 128) at the price of 128 blocks at b4 h1 s1024,
//   one wave.  Shared memory: 194 KB, 204 KB with a bias.  Bound at the
//   heads-512 shape: 3 x 6.4 GFLOP, 0.039 ms at 495 TFLOP/s.
//
// float32 K2 at every width up to 256 runs on the tensor cores as 3xTF32
// split products (`dkdv_tf32_kernel<D, true>`), in dkdv_mma_kernel's
// shape: every
// operand x is split into two tf32 values, hi = rn(x) and lo = rn(x -
// hi), and each
// of the five products is lo.hi + hi.lo + hi.hi by mma.sync m16n8k8 into
// f32 (lo.lo dropped), which holds the f32 bar of 1e-4 against the plain
// version.  The TPU kernels split into bf16 hi / lo instead (Mosaic has no
// TF32 tier); at 8 l2norm groups and scale 8 that split misses the bar,
// TF32's 11 significant bits a part do not.  4 warps own 64 keys, 16 a
// warp; K and V arrive once as f32, K is split once for the block (hi in
// place, lo beside it: every warp reads all of K for dQ), V at each A
// fragment (each warp reads only its own rows).  Q, dO' and delta' tiles
// (64 queries up to d 32, 32 above: at d 64 two blocks share an SM) stream
// through a double-buffered cp.async ring, and each tile of Q and dO' is
// split once for the block after it lands.  S^T = K.Q^T and dP^T =
// V.dO'^T, then e^T and dS^T in f32 (hidden entries selected to exact 0,
// masks skipped on whole tiles); dV += e^T.dO' and dK += dS^T.Q with e and
// dS split in registers: the C fragment of S^T holds queries 2q and 2q +
// 1, which serve as the tf32 A fragment's k indices q and q + 4 when dO'
// and Q rows are read in that order (add_product_tf32x3), so they never
// touch shared memory.  dS itself is staged (queries x keys, f32) for dQ's
// dS.K, added to the f32 scratch by red.global.add.v2.f32 as in
// dkdv_mma_kernel.  Shared memory 111 KB at d 64, 207 KB at d 128.
// Above d 128 (as in dkdv_mma_kernel) a warp cannot hold both dK and dV
// of its 16 keys (2 x 16 x d f32, 256 registers a thread at d 256), and
// 64 keys of f32 K (hi and lo) and V beside the query tiles would take
// ~300 KB at d 256: a block's 4 warps own 32 keys, two for each 16.  The
// first forms S^T and e^T, hands e^T to the second through shared memory
// (at the places the second then writes dS^T over, lane for lane) and
// forms dV += e^T.dO'; the second forms dP^T, dS^T and dK += dS^T.Q; all
// four share dQ += dS.K.  So S is formed once, each warp forms two of the
// five products, and a tile costs one barrier more.  Each warp sums its
// S^T or dP^T over d / 8 k steps in four accumulators (hi.hi and the
// small terms apart, each by the k step's parity): four chains of
// dependent mma, and a quarter as many roundings toward zero on each,
// which over 16384 queries of mean-3 values kept dQ and dK at the f32
// bar (one accumulator read 1.7e-4 there: dP sums 256 terms of one sign,
// and dS takes the difference of two such sums).  Query tiles of 32 at d
// 192 and 16 at d 256.  Shared memory (K hi and lo, V, six query tiles,
// dS): 225 KB at d 192, 197 KB at d 256.  At d 192, 16-query tiles, or
// 64 keys on 8 warps, ran 0.396 and 0.461 ms against 0.364 at b4 h2 s1024
// causal on an H100 (d 256 fits no other shape).
// The tensor cores round each f32 sum toward zero, and a chain of such
// sums on one accumulator drifts with its length (~1.5e-5 of max|g| at
// 1024 queries, 3 x 128 of them); dK and dV sum G x seq_q queries, so
// every 256 queries the chain is closed: its sums are added, to nearest,
// into the block's own dK and dV rows in global memory, and the
// accumulators restart from 0.
//
// float32 K3b is the same kernel without dQ (`dkdv_tf32_kernel<D,
// false>`): no dS staging and no dQ products, so no warp reads another
// warp's keys and K, like V, is split at each A fragment load (no K lo
// tile); the bias tile (BQ queries x BK keys, f32) streams through the
// cp.async ring with Q and dO' and is added to the logit in f32, never
// split.  Shared memory 85 KB at d 64, 102 KB with a bias: two blocks an
// SM either way.  Above d 128 it keeps K2's two warps for each 16 keys:
// the dV warp forms S^T (K split at each fragment load: only it reads
// those keys), adds the bias, forms e^T, hands it to the dK warp through
// a staging tile of its own (the bias tiles need theirs) and forms dV +=
// e^T.dO'; the dK warp forms dP^T, dS^T and dK += dS^T.Q, the sums of S^T
// and dP^T in four accumulators as K2's.  Shared memory with a bias 210
// KB at d 192 (32-query tiles), 169 KB at d 256 (16).  Its dK and dV
// chains are closed every 256 queries as K2's.
//
// float32 K3a runs on the tensor cores as 3xTF32 split products
// (`dq_tf32_kernel`), in dq_mma_kernel's shape: 4 warps own 64
// queries, 16 a warp, query tiles heaviest first, causal key loops
// stopped at the block's last diagonal.  Q and dO' arrive once as f32 and
// stay in shared memory; each warp reads only its own rows, so their A
// fragments are split as they are read.  K, V and, with a bias, the bias
// tile stream through a double-buffered cp.async ring (32 keys a tile
// from d 64: two blocks an SM at d 64, 85 KB, 105 KB with a bias; 64
// below); K and V are read by every warp and split once for the block
// after they land (hi in place, lo beside).  S = Q.K^T and dP' = dO'.V^T
// by mma_tf32x3; e and dS in f32, the bias added as bias * log2e, hidden
// entries selected to exact 0, masks skipped on whole tiles; dS added to
// dB by float2 red adds before any rounding (scalar adds at odd seq_k),
// with no cap on the bias's shared axis.  dQ += dS.K keeps dS in
// registers: the C fragment of S holds keys 2q and 2q + 1, the tf32 A
// fragment's k indices q and q + 4 when K's rows are read in that order
// (add_product_tf32x3).  One dQ accumulator sums seq_k keys, each mma
// rounding toward zero: every 256 keys its chain is closed into a running
// sum in registers, added to nearest, and restarts from 0.
// Above d 128 the same block and key loop, but Q and dO' take 133 KB at d
// 256 (64 queries of f32 rows), so K and V have no room for their lo
// tiles and are split at each fragment load like Q and dO' (keys a tile:
// 32 at d 192, 16 at d 256); S and dP' are each summed in four
// accumulators (hi.hi and the small terms apart, each by the k step's
// parity), as K2's S^T and dP^T above d 128, which holds dQ at the f32
// bar over 16384 keys of mean-3 values; dQ's D / 2 accumulators a thread
// leave no room for a running sum, so every 256 keys its chain is closed
// into the thread's own dQ words in global memory, added to nearest (the
// block owns those rows: no race).  Shared memory with a bias 216 KB at d
// 192, 207 KB at d 256.  The other layout that fits, 32 queries a block
// with two warps for each 16 (each summing S and dP' over half of d, the
// halves added through shared memory, K and V split once for the block,
// 177 KB at d 256), ran 0.342-0.348 ms against 0.320-0.326 at d 192 and
// 0.470 against 0.470 at d 256 (b4 h2 s1024 causal, an (h, i, j) bias,
// on an H100), so the kernel keeps the simpler one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "mma_common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;        // (B, H, seq_q, d)
  const void* k;        // (B, KVH, seq_k, d)
  const void* v;        // (B, KVH, seq_k, d)
  const void* dO;       // (B, H, seq_q, d), pre-scaled by inv_l
  const float* delta;   // (B, H, seq_q), rowsum(dO * O) * inv_l
  const uint8_t* mask;  // (B, seq_k) or null
  const float* bias;    // (B|H, seq_q, seq_k) or null
  void* dq;             // (B, H, seq_q, d)            dq_kernel
  float* dq_acc;        // (B, H, seq_q, d) f32, zeroed K2's scratch
  void* dk;             // (B, KVH, seq_k, d)          dkdv_kernel
  void* dv;
  float* db;            // (B|H, seq_q, seq_k) f32, zeroed, or null
  int H, KVH, seq_q, seq_k, causal, bias_batch_dim;
  float scale, c;       // c = scale * log2e
};

// ---------------------------------------------------------------------------
// Tensor-core dK/dV kernel (bf16): K2 (DQ = true) and K3b (DQ = false).
// Grid (KVH, B, key tiles); L::NT threads, warp w owning keys
// k0 + 16 (w % 4) ..

constexpr int MBK = 64;  // keys per block: 16 a warp, 4 key groups

template <int D, bool DQ>
struct MmaLayout {
  // warps: up to d 128 one a key group, forming dK and dV; above, two,
  // one forming dV and one dK (a thread holds d / 2 accumulators either way)
  static constexpr int W = D > 128 ? 8 : 4;
  static constexpr int NT = 32 * W;
  // queries per tile: fewer at larger d keep the S tiles and the
  // accumulators within 255 registers (K3b's bias path needs 16 at d 128)
  static constexpr int BQ =
      D <= 64 ? 64 : D <= 128 ? (DQ || D <= 96 ? 32 : 16) : D <= 192 ? 32 : 16;
  static constexpr int RS = 2 * D + 16;        // bf16 row stride, bytes: an
  static constexpr int SS = 2 * BQ + 16;       // odd count of 16-byte units,
                                               // so ldmatrix rows hit 8 banks
  static constexpr int BS = MBK + 4;           // bias row stride, floats:
                                               // 2 rows apart = 8 banks
  static constexpr size_t KV = size_t(MBK) * RS;  // the K or V tile
  static constexpr size_t QT = size_t(BQ) * RS;   // one Q or dO' tile
  // K, V; two Q and two dO' tiles; two delta' rows; then K2's dS^T hi and
  // lo tiles, or K3b's two bias tiles (BQ queries x 64 keys, f32)
  static constexpr size_t BASE = 2 * KV + 4 * QT + 2 * BQ * sizeof(float);
  static constexpr size_t DST = 2 * size_t(MBK) * SS;
  static constexpr size_t BIAS = 2 * size_t(BQ) * BS * sizeof(float);
};

// Two f32 values as bf16 pairs hi (x rounded) and lo (x - hi rounded): a
// product that takes both sees x to ~16 bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The A fragments (hi, lo) of k16 step j from the C fragments of n8 tiles
// 2j and 2j + 1 of a (16 x N) f32 tile
template <int NQ>
__device__ __forceinline__ void split_a(const float (&c)[NQ][4], int j,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c[2 * j][0], c[2 * j][1], hi[0], lo[0]);
  split_bf16(c[2 * j][2], c[2 * j][3], hi[1], lo[1]);
  split_bf16(c[2 * j + 1][0], c[2 * j + 1][1], hi[2], lo[2]);
  split_bf16(c[2 * j + 1][2], c[2 * j + 1][3], hi[3], lo[3]);
}

// acc (16 x D, C fragments) += c . src, where c is a (16 x N) f32 tile in C
// fragments fed as bf16 hi + lo A fragments, and src an (N x D) bf16 tile
// in shared memory, rows RS bytes apart, read by ldmatrix.trans
template <int N, int D, int RS>
__device__ __forceinline__ void add_product(float (&acc)[D / 8][4],
                                            const float (&c)[N / 8][4],
                                            const unsigned char* src, int lane) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    uint32_t ah[4], al[4];
    split_a(c, j, ah, al);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, src + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                               (dn * 16 + (lane >> 4) * 8) * 2);
      mma_bf16(acc[2 * dn], ah, b[0], b[1]);
      mma_bf16(acc[2 * dn], al, b[0], b[1]);
      mma_bf16(acc[2 * dn + 1], ah, b[2], b[3]);
      mma_bf16(acc[2 * dn + 1], al, b[2], b[3]);
    }
  }
}

// An f32 bias tile: rows [0, nrows) x columns [0, ncols) of the (*, ld)
// matrix at `src` (from its tile corner; rows past `rows`, columns past
// `cols` as zeros) to shared memory rows `stride` floats apart; 16-byte
// copies where every row starts 16-byte aligned (`by16`), else 4-byte ones
template <int NTH>
__device__ __forceinline__ void load_bias_tile(float* dst, const float* src,
                                               int nrows, int ncols, int rows,
                                               int cols, int ld, int stride,
                                               bool by16) {
  if (by16) {
    const int per_row = ncols / 4;
    for (int idx = threadIdx.x; idx < nrows * per_row; idx += NTH) {
      const int r = idx / per_row, c = (idx % per_row) * 4;
      const int n = r < rows ? 4 * max(0, min(4, cols - c)) : 0;
      cp_async16(dst + r * stride + c, n ? src + size_t(r) * ld + c : src, n);
    }
  } else {
    for (int idx = threadIdx.x; idx < nrows * ncols; idx += NTH) {
      const int r = idx / ncols, c = idx % ncols;
      const bool in = r < rows && c < cols;
      cp_async4(dst + r * stride + c, in ? src + size_t(r) * ld + c : src,
                in ? 4 : 0);
    }
  }
}

// T: __nv_bfloat16 (q, k, v, dO' and dK, dV)
template <typename T, int D, bool DQ>
__global__ void __launch_bounds__(MmaLayout<D, DQ>::NT, 1)
    dkdv_mma_kernel(Params p) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 operands");
  using L = MmaLayout<D, DQ>;
  constexpr int BQ = L::BQ, RS = L::RS, SS = L::SS, W = L::W, NTH = L::NT;
  constexpr bool SPLIT = W == 8;  // a warp forms dV or dK, not both
  constexpr int NACC = SPLIT ? 1 : 2;
  constexpr int NQ = BQ / 8;     // n8 tiles of a warp's (16 keys x BQ) tile
  constexpr int ND = D / 8;      // n8 tiles over the head dim
  constexpr int QG = BQ / 16;    // dQ: 16-query groups of a tile ...
  constexpr int DP = W / QG;     // ... and the head-dim parts per group
  constexpr int NDQ = ND / DP;   // n8 tiles of a warp's dQ part, formed
  constexpr int NH = !SPLIT && D > 96 ? 2 : 1;  // in NH passes (d 128:
  constexpr int NDH = NDQ / NH;                 // registers)
  static_assert(NDH % 2 == 0, "dQ passes take pairs of n8 tiles");
  extern __shared__ __align__(16) unsigned char msmem[];
  unsigned char* ks = msmem;
  unsigned char* vs = ks + L::KV;
  unsigned char* qs = vs + L::KV;        // 2 buffers
  unsigned char* dos = qs + 2 * L::QT;   // 2 buffers
  float* dls = reinterpret_cast<float*>(dos + 2 * L::QT);  // 2 x BQ
  unsigned char* dss = reinterpret_cast<unsigned char*>(dls + 2 * BQ);
  float* bss = dls + 2 * BQ;             // K3b: 2 bias tiles in dS^T's room

  const int kvhi = blockIdx.x, bi = blockIdx.y, k0 = blockIdx.z * MBK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int kg = warp & 3;                        // the warp's 16 keys
  const bool forms_dv = !SPLIT || warp < 4;       // warp-uniform roles
  const bool forms_dk = !SPLIT || warp >= 4;
  const int G = p.H / p.KVH, diff = p.seq_k - p.seq_q;
  const size_t kvrow0 = (size_t(bi) * p.KVH + kvhi) * p.seq_k;
  const uint8_t* mb = p.mask ? p.mask + size_t(bi) * p.seq_k : nullptr;

  // (head, q tile) pairs that see the block's keys: the causal start is the
  // first query row that sees key k0
  const int qfirst = p.causal ? max(0, k0 - diff) : 0;
  const int qt0 = qfirst / BQ;
  const int per_head = max(0, (p.seq_q + BQ - 1) / BQ - qt0);
  const int total = G * per_head;

  auto q_rows = [&](int it) {  // the query rows' first index, (b, h, 0)
    return (size_t(bi) * p.H + kvhi * G + it / per_head) * p.seq_q;
  };
  // bias rows in 16-byte units
  const bool bias16 =
      p.seq_k % 4 == 0 && reinterpret_cast<uintptr_t>(p.bias) % 16 == 0;
  auto load_tile = [&](int it, int buf) {
    const size_t qrow0 = q_rows(it);
    const int q0 = (qt0 + it % per_head) * BQ;
    load_rows<2 * D, RS, NTH>(qs + buf * L::QT,
                               static_cast<const T*>(p.q) + qrow0 * D, q0, BQ,
                               p.seq_q);
    load_rows<2 * D, RS, NTH>(dos + buf * L::QT,
                               static_cast<const T*>(p.dO) + qrow0 * D, q0,
                               BQ, p.seq_q);
    for (int i = tid; i < BQ; i += NTH) {
      const bool in = q0 + i < p.seq_q;
      cp_async4(dls + buf * BQ + i, in ? p.delta + qrow0 + q0 + i : p.delta,
                in ? 4 : 0);
    }
    if (DQ || p.bias == nullptr) return;
    // the bias tile (queries q0.., keys k0..), past either length as 0
    const int hb = p.bias_batch_dim ? bi : kvhi * G + it / per_head;
    load_bias_tile<NTH>(bss + buf * BQ * L::BS,
                        p.bias + (size_t(hb) * p.seq_q + q0) * p.seq_k + k0,
                        BQ, MBK, p.seq_q - q0, p.seq_k - k0, p.seq_k, L::BS,
                        bias16);
  };

  if (total > 0) {
    load_rows<2 * D, RS, NTH>(ks, static_cast<const T*>(p.k) + kvrow0 * D,
                               k0, MBK, p.seq_k);
    load_rows<2 * D, RS, NTH>(vs, static_cast<const T*>(p.v) + kvrow0 * D,
                               k0, MBK, p.seq_k);
    load_tile(0, 0);
  }
  cp_async_commit();

  // up to d 128: dV, then dK; above, the one this warp forms
  float acc[NACC][ND][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
  // this thread's keys: C rows g and g + 8 of the warp's 16
  const int keys[2] = {k0 + kg * 16 + g, k0 + kg * 16 + g + 8};
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    key_ok[h] = keys[h] < p.seq_k && (mb == nullptr || mb[keys[h]] != 0);
  const bool keys_whole = mb == nullptr && k0 + MBK <= p.seq_k;

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) load_tile(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile it (and, at it 0, K and V) has landed
    const size_t qrow0 = q_rows(it);
    const int q0 = (qt0 + it % per_head) * BQ;
    const unsigned char* qt = qs + buf * L::QT;
    const unsigned char* dot = dos + buf * L::QT;
    const float* dl = dls + buf * BQ;

    // S^T = K.Q^T, dP^T = V.dO'^T (dP^T only where dK is formed): an x4
    // ldmatrix of Q / dO' gives the B fragments of 2 n8 tiles
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int st = 0; st < D / 16; ++st) {
      uint32_t ka[4], va[4];
      const int arow = (kg * 16 + (lane & 15)) * RS + st * 32 + (lane >> 4) * 16;
      ldmatrix_x4(ka, ks + arow);
      if (forms_dk) ldmatrix_x4(va, vs + arow);
#pragma unroll
      for (int j = 0; j < NQ / 2; ++j) {
        const int brow = (j * 16 + (lane & 7) + (lane >> 4) * 8) * RS +
                         st * 32 + ((lane >> 3) & 1) * 16;
        uint32_t b[4];
        ldmatrix_x4(b, qt + brow);
        mma_bf16(s[2 * j], ka, b[0], b[1]);
        mma_bf16(s[2 * j + 1], ka, b[2], b[3]);
        if (forms_dk) {
          ldmatrix_x4(b, dot + brow);
          mma_bf16(dp[2 * j], va, b[0], b[1]);
          mma_bf16(dp[2 * j + 1], va, b[2], b[3]);
        }
      }
    }

    // e^T into s, dS^T into dp, in the C layout: entry (n, 2h + x) is key
    // keys[h], query q0 + 8n + 2tq + x.  A tile whose every (key, query)
    // pair is visible (no key mask, inside both lengths and the causal
    // diagonal) skips the masks; the bias comes from its staged tile
    const bool whole = keys_whole && q0 + BQ <= p.seq_q &&
                       (!p.causal || k0 + MBK - 1 <= q0 + diff);
    const bool has_bias = !DQ && p.bias != nullptr;
    const float* bt = bss + buf * BQ * L::BS + kg * 16 + g;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int col = n * 8 + 2 * tq + x, qr = q0 + col;
        const float dlt = dl[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float lg = s[n][2 * h + x] * p.c;
          if (has_bias) lg += bt[col * L::BS + 8 * h] * LOG2E;
          float e, ds;
          if (whole) {
            e = exp2f(lg);
            ds = e * (dp[n][2 * h + x] - dlt);
          } else {
            bool keep = key_ok[h] && qr < p.seq_q;
            if (p.causal) keep = keep && keys[h] <= qr + diff;
            e = keep ? exp2f(lg) : 0.f;
            ds = keep ? e * (dp[n][2 * h + x] - dlt) : 0.f;
          }
          s[n][2 * h + x] = e;
          dp[n][2 * h + x] = ds;
        }
      }

    if constexpr (DQ) {  // stage dS^T (keys x queries) for dQ = dS.K
      if (forms_dk) {
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int at = (kg * 16 + g + 8 * h) * SS + (n * 8 + 2 * tq) * 2;
            split_bf16(dp[n][2 * h], dp[n][2 * h + 1],
                       *reinterpret_cast<uint32_t*>(dss + at),
                       *reinterpret_cast<uint32_t*>(dss + MBK * SS + at));
          }
      }
    }

    // dV += e^T.dO', then dK += dS^T.Q: n8 tiles 2j, 2j + 1 of e^T / dS^T
    // are the A fragments (hi and lo) of k16 step j (queries 16j ..); two
    // passes, so one operand's fragments are live at a time (d 128 stays
    // within 255 registers)
    if (forms_dv) add_product<BQ, D, RS>(acc[0], s, dot, lane);
    if (forms_dk) add_product<BQ, D, RS>(acc[NACC - 1], dp, qt, lane);

    if constexpr (DQ) {
      // dQ rows of this tile += dS.K over the block's 64 keys: warp w takes
      // query group w % QG and head-dim part w / QG; dS^T (hi and lo) is
      // read by ldmatrix.trans as dS's A fragments, K by ldmatrix.trans
      __syncthreads();  // every warp's dS^T is staged
      const int qg = warp % QG, dpart = warp / QG;
      float* dqb = p.dq_acc + qrow0 * D;
#pragma unroll
      for (int hp = 0; hp < NH; ++hp) {
        const int c0 = (dpart * NDQ + hp * NDH) * 8;  // the pass's columns
        float dq[NDH][4];
#pragma unroll
        for (int n = 0; n < NDH; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < MBK / 16; ++kk) {
          const int arow = (kk * 16 + (lane & 7) + (lane >> 4) * 8) * SS +
                           (qg * 16 + ((lane >> 3) & 1) * 8) * 2;
          uint32_t ah[4], al[4];
          ldmatrix_x4_trans(ah, dss + arow);
          ldmatrix_x4_trans(al, dss + MBK * SS + arow);
#pragma unroll
          for (int dn = 0; dn < NDH / 2; ++dn) {
            uint32_t b[4];
            ldmatrix_x4_trans(
                b, ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                       (c0 + dn * 16 + (lane >> 4) * 8) * 2);
            mma_bf16(dq[2 * dn], ah, b[0], b[1]);
            mma_bf16(dq[2 * dn], al, b[0], b[1]);
            mma_bf16(dq[2 * dn + 1], ah, b[2], b[3]);
            mma_bf16(dq[2 * dn + 1], al, b[2], b[3]);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = q0 + qg * 16 + g + 8 * h;
          if (row >= p.seq_q) continue;
#pragma unroll
          for (int n = 0; n < NDH; ++n)
            atomicAdd(reinterpret_cast<float2*>(
                          dqb + size_t(row) * D + c0 + n * 8 + 2 * tq),
                      make_float2(dq[n][2 * h], dq[n][2 * h + 1]));
        }
      }
    }
    __syncthreads();  // the next tile's loads may overwrite this buffer
  }
  cp_async_wait<0>();

  T* dkb = static_cast<T*>(p.dk) + kvrow0 * D;
  T* dvb = static_cast<T*>(p.dv) + kvrow0 * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] >= p.seq_k) continue;
    const size_t at = size_t(keys[h]) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float* a = acc[NACC - 1][n];
      if (forms_dk)
        *reinterpret_cast<uint32_t*>(dkb + at + n * 8) =
            pack_bf16(a[2 * h] * p.scale, a[2 * h + 1] * p.scale);
      if (forms_dv)
        *reinterpret_cast<uint32_t*>(dvb + at + n * 8) =
            pack_bf16(acc[0][n][2 * h], acc[0][n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core f32 K2 (DQ = true) and K3b (DQ = false), 3xTF32: grid (KVH,
// B, key tiles).  Up to d 128 4 warps own 64 keys, warp w keys k0 + 16 w
// ..; above 4 warps own 32 keys, two for each 16 (see Tf32Layout)

template <int D, bool DQ>
struct Tf32Layout {
  // above d 128 a warp forms dV or dK, not both: 16 keys x d f32 for each
  // are d / 2 registers a thread, 128 at d 256 (dkdv_mma_kernel's split)
  static constexpr bool SPLIT = D > 128;
  static constexpr int BK = SPLIT ? 32 : 64;        // keys a block
  static constexpr int KG = BK / 16;                // key groups of 16
  static constexpr int W = SPLIT ? 2 * KG : KG;     // warps
  static constexpr int NT = 32 * W;
  // queries per tile: 32 at d 64 (two blocks an SM) and up to d 128 (dK's
  // and dV's 2 x D / 2 accumulators, the S^T and dP^T tiles and the
  // fragments within 255 registers, and shared memory) and at d 192; 16
  // at d 256
  static constexpr int BQ = D <= 32 ? 64 : D <= 192 ? 32 : 16;
  // f32 rows of D + 4 floats, (4D + 16) bytes: an odd count of 16-byte
  // units (the 8 rows an ldmatrix reads hit 8 banks), 2 rows 8 banks
  // apart (add_product_tf32x3's reads)
  static constexpr int RF = D + 4;
  static constexpr int RS = 4 * RF;
  // dS (queries x keys) and bias (queries x keys) row strides, floats: a
  // warp's 32 dS staging writes and bias reads, rows 2q + x and columns
  // g, hit 32 banks
  static constexpr int DSS = BK + 4;
  static constexpr int BS = BK + 4;
  static constexpr size_t KV = size_t(BK) * RS;  // the K or V tile
  static constexpr size_t QT = size_t(BQ) * RS;  // one Q or dO' tile
  // K (K2: split in place into its hi, its lo beside it; K3b: split at
  // each fragment load), V; two Q and two dO' tiles (each split in place
  // into its hi), the current tile's Q and dO' lo; two delta' rows; the
  // staging tile (BQ queries x BK keys, f32: K2's dS, and above d 128 the
  // e^T that the dV warps hand to the dK warps); then K3b's two bias
  // tiles (BQ queries x BK keys, f32)
  static constexpr bool STAGE = DQ || SPLIT;
  static constexpr size_t DST = size_t(BQ) * DSS * sizeof(float);
  static constexpr size_t BASE = (DQ ? 3 : 2) * KV + 6 * QT +
                                 2 * size_t(BQ) * sizeof(float) +
                                 (STAGE ? DST : 0);
  static constexpr size_t BIAS = 2 * size_t(BQ) * BS * sizeof(float);
};

// Closes a chain of sums rounded toward zero: a warp's C fragments acc
// (this thread's rows[0] and rows[1], those at or past `limit` skipped,
// and columns 8n + 2tq, + 1 of its first nd8 n8 tiles), times `mul`, go to
// those places of `dst` (rows `ld` floats apart), added to nearest to
// what an earlier chain left there (`stored`); acc restarts from 0
template <int NA>
__device__ __forceinline__ void close_chain_rows(float (&acc)[NA][4],
                                                 float* dst,
                                                 const int (&rows)[2],
                                                 int limit, size_t ld,
                                                 int nd8, float mul,
                                                 bool stored, int tq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= limit) continue;
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      if (n >= nd8) break;
      float2* w = reinterpret_cast<float2*>(dst + size_t(rows[h]) * ld +
                                            n * 8 + 2 * tq);
      float2 x = make_float2(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
      if (stored) {
        const float2 y = *w;
        x.x += y.x, x.y += y.y;
      }
      *w = x;
    }
  }
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

template <int D, bool DQ>
__global__ void __launch_bounds__(Tf32Layout<D, DQ>::NT, 1)
    dkdv_tf32_kernel(Params p) {
  using L = Tf32Layout<D, DQ>;
  constexpr int BQ = L::BQ, BK = L::BK, RS = L::RS, RF = L::RF, DSS = L::DSS;
  constexpr int NTH = L::NT, KG = L::KG;
  constexpr bool SPLIT = L::SPLIT;
  constexpr int NACC = SPLIT ? 1 : 2;  // dV and dK, or the warp's one
  constexpr int NQ = BQ / 8;    // n8 tiles of a warp's (16 keys x BQ) tile
  constexpr int ND = D / 8;     // n8 tiles over the head dim
  constexpr int QG = BQ / 16;   // dQ: 16-query groups of a tile ...
  constexpr int DP = L::W / QG;  // ... and the head-dim parts per group
  constexpr int NDQ = ND / DP;  // n8 tiles of a warp's dQ part, formed
  // in NH passes (d 128, where a warp holds both dK and dV: registers)
  constexpr int NH = !SPLIT && D > 96 ? 2 : 1;
  constexpr int NDH = NDQ / NH;
  static_assert(ND % DP == 0 && NDQ % NH == 0,
                "dQ parts and passes split the head dim evenly");
  extern __shared__ __align__(16) unsigned char msmem[];
  unsigned char* ks = msmem;
  unsigned char* kls = ks + L::KV;       // K2: K's lo
  unsigned char* vs = ks + (DQ ? 2 : 1) * L::KV;
  unsigned char* qs = vs + L::KV;        // 2 buffers
  unsigned char* dos = qs + 2 * L::QT;   // 2 buffers
  unsigned char* qls = dos + 2 * L::QT;  // the current tile's lo
  unsigned char* dols = qls + L::QT;
  float* dls = reinterpret_cast<float*>(dols + L::QT);  // 2 x BQ
  float* dss = dls + 2 * BQ;             // STAGE: BQ x DSS
  float* bss = dss + (L::STAGE ? BQ * DSS : 0);  // K3b: 2 bias tiles

  const int kvhi = blockIdx.x, bi = blockIdx.y, k0 = blockIdx.z * BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int kg = warp % KG;                       // the warp's 16 keys
  const bool forms_dv = !SPLIT || warp < KG;      // warp-uniform roles
  const bool forms_dk = !SPLIT || warp >= KG;
  const int G = p.H / p.KVH, diff = p.seq_k - p.seq_q;
  const size_t kvrow0 = (size_t(bi) * p.KVH + kvhi) * p.seq_k;
  const uint8_t* mb = p.mask ? p.mask + size_t(bi) * p.seq_k : nullptr;

  // (head, q tile) pairs that see the block's keys: the causal start is the
  // first query row that sees key k0
  const int qfirst = p.causal ? max(0, k0 - diff) : 0;
  const int qt0 = qfirst / BQ;
  const int per_head = max(0, (p.seq_q + BQ - 1) / BQ - qt0);
  const int total = G * per_head;

  auto q_rows = [&](int it) {  // the query rows' first index, (b, h, 0)
    return (size_t(bi) * p.H + kvhi * G + it / per_head) * p.seq_q;
  };
  // bias rows in 16-byte units
  const bool bias16 =
      p.seq_k % 4 == 0 && reinterpret_cast<uintptr_t>(p.bias) % 16 == 0;
  auto load_tile = [&](int it, int buf) {
    const size_t qrow0 = q_rows(it);
    const int q0 = (qt0 + it % per_head) * BQ;
    load_rows<4 * D, RS, NTH>(qs + buf * L::QT,
                               static_cast<const float*>(p.q) + qrow0 * D, q0,
                               BQ, p.seq_q);
    load_rows<4 * D, RS, NTH>(dos + buf * L::QT,
                               static_cast<const float*>(p.dO) + qrow0 * D, q0,
                               BQ, p.seq_q);
    for (int i = tid; i < BQ; i += NTH) {
      const bool in = q0 + i < p.seq_q;
      cp_async4(dls + buf * BQ + i, in ? p.delta + qrow0 + q0 + i : p.delta,
                in ? 4 : 0);
    }
    if (DQ || p.bias == nullptr) return;
    // K3b: the bias tile (queries q0.., keys k0..), past either length as 0
    const int hb = p.bias_batch_dim ? bi : kvhi * G + it / per_head;
    load_bias_tile<NTH>(bss + buf * BQ * L::BS,
                        p.bias + (size_t(hb) * p.seq_q + q0) * p.seq_k + k0,
                        BQ, BK, p.seq_q - q0, p.seq_k - k0, p.seq_k, L::BS,
                        bias16);
  };

  if (total > 0) {
    load_rows<4 * D, RS, NTH>(ks, static_cast<const float*>(p.k) + kvrow0 * D,
                               k0, BK, p.seq_k);
    load_rows<4 * D, RS, NTH>(vs, static_cast<const float*>(p.v) + kvrow0 * D,
                               k0, BK, p.seq_k);
    load_tile(0, 0);
  }
  cp_async_commit();

  // dV, then dK; above d 128 the one this warp forms
  float acc[NACC][ND][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
  // this thread's keys: C rows g and g + 8 of the warp's 16
  const int keys[2] = {k0 + kg * 16 + g, k0 + kg * 16 + g + 8};
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    key_ok[h] = keys[h] < p.seq_k && (mb == nullptr || mb[keys[h]] != 0);
  const bool keys_whole = mb == nullptr && k0 + BK <= p.seq_k;
  const float* kf = reinterpret_cast<const float*>(ks);
  const float* klf = reinterpret_cast<const float*>(kls);

  // dK and dV sum G x seq_q queries, each mma rounding its sum toward zero.
  // Every CHAIN tiles (256 queries) the chain is closed: the sums so far go
  // into the block's own dK and dV rows, added to nearest to what earlier
  // chains left there, and the accumulators restart from 0
  constexpr int CHAIN = 256 / BQ;
  bool stored = false;
  auto close_chain = [&]() {
    if (forms_dk)  // acc[1], or above d 128 this warp's one
      close_chain_rows(acc[NACC - 1], static_cast<float*>(p.dk) + kvrow0 * D,
                       keys, p.seq_k, D, ND, p.scale, stored, tq);
    if (forms_dv)
      close_chain_rows(acc[0], static_cast<float*>(p.dv) + kvrow0 * D, keys,
                       p.seq_k, D, ND, 1.f, stored, tq);
    stored = true;
  };

  // chains of CHAIN tiles, each closed at its end; with no tile at all
  // (total 0) one empty chain stores the block's zero dK and dV
  for (int ch = 0; ch == 0 || ch < total; ch += CHAIN) {
    for (int it = ch; it < min(ch + CHAIN, total); ++it) {
      const int buf = it & 1;
      if (it + 1 < total) load_tile(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // tile it (and, at it 0, K and V) has landed
      const size_t qrow0 = q_rows(it);
      const int q0 = (qt0 + it % per_head) * BQ;
      unsigned char* qt = qs + buf * L::QT;
      unsigned char* dot = dos + buf * L::QT;
      const float* dl = dls + buf * BQ;
      // every warp reads all of the tile's Q and dO' rows, and (K2's dQ)
      // all of K: split them once, for the block.  V, and K3b's K, are
      // read by their own warp only, and split at each fragment load
      if (DQ && it == 0) split_rows<D, RS, NTH>(ks, kls, BK);
      split_rows<D, RS, NTH>(qt, qls, BQ);
      split_rows<D, RS, NTH>(dot, dols, BQ);
      __syncthreads();  // the tiles' hi and lo are in place

      const bool whole = keys_whole && q0 + BQ <= p.seq_q &&
                         (!p.causal || k0 + BK - 1 <= q0 + diff);
      // K3b's bias comes from its staged tile (this thread's keys, row
      // `col` at bt[col * BS + 8 h]), added to the logit in f32, never split
      const bool has_bias = !DQ && p.bias != nullptr;
      const float* bt = bss + buf * BQ * L::BS + kg * 16 + g;
      if constexpr (SPLIT) {
        // above d 128 a warp forms one product: S^T = K.Q^T (the warps
        // that form dV: K2's K hi and lo tiles; K3b's K, read by these
        // warps alone, split at each fragment load) or dP^T = V.dO'^T (the
        // warps that form dK: V split at each fragment load), B fragments
        // by x4 ldmatrix of Q's / dO''s hi and lo.  hi.hi sums into xb, the
        // small terms lo.hi + hi.lo into xs, each in two accumulators by
        // the k step's parity: four chains of dependent mma instead of
        // one, and shorter chains of sums rounded toward zero (dP's terms
        // share a sign where v and dO' do, and dS = e (dP - delta) takes
        // the difference of two such sums)
        float xb[2][NQ][4], xs[2][NQ][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int n = 0; n < NQ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) xb[r][n][e] = xs[r][n][e] = 0.f;
        const unsigned char* bhi = forms_dv ? qt : dot;
        const unsigned char* blo = forms_dv ? qls : dols;
#pragma unroll
        for (int st = 0; st < D / 8; ++st) {
          uint32_t ah[4], al[4];
          const int arow =
              (kg * 16 + (lane & 15)) * RS + st * 32 + (lane >> 4) * 16;
          if (DQ && forms_dv) {
            ldmatrix_x4(ah, ks + arow);
            ldmatrix_x4(al, kls + arow);
          } else {
            uint32_t a[4];
            ldmatrix_x4(a, (forms_dv ? ks : vs) + arow);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
          }
          const int r = st & 1;
#pragma unroll
          for (int j = 0; j < NQ / 2; ++j) {
            const int brow = (j * 16 + (lane & 7) + (lane >> 4) * 8) * RS +
                             st * 32 + ((lane >> 3) & 1) * 16;
            uint32_t bh[4], bl[4];
            ldmatrix_x4(bh, bhi + brow);
            ldmatrix_x4(bl, blo + brow);
            mma_tf32(xs[r][2 * j], al, bh[0], bh[1]);
            mma_tf32(xs[r][2 * j], ah, bl[0], bl[1]);
            mma_tf32(xb[r][2 * j], ah, bh[0], bh[1]);
            mma_tf32(xs[r][2 * j + 1], al, bh[2], bh[3]);
            mma_tf32(xs[r][2 * j + 1], ah, bl[2], bl[3]);
            mma_tf32(xb[r][2 * j + 1], ah, bh[2], bh[3]);
          }
        }
        float x[NQ][4];  // S^T or dP^T, then e^T or dS^T
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[n][e] = (xb[0][n][e] + xb[1][n][e]) +
                      (xs[0][n][e] + xs[1][n][e]);
        // the dV warps form e^T (masked as below) and stage it at dS's
        // places, where the dK warp of the same keys (the same lanes) reads
        // it (and K2's writes dS over it)
        if (forms_dv) {
#pragma unroll
          for (int n = 0; n < NQ; ++n)
#pragma unroll
            for (int xx = 0; xx < 2; ++xx) {
              const int col = n * 8 + 2 * tq + xx, qr = q0 + col;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                bool keep = whole;
                if (!whole) {
                  keep = key_ok[h] && qr < p.seq_q;
                  if (p.causal) keep = keep && keys[h] <= qr + diff;
                }
                float lg = x[n][2 * h + xx] * p.c;
                if (has_bias) lg += bt[col * L::BS + 8 * h] * LOG2E;
                const float e = keep ? exp2f(lg) : 0.f;
                x[n][2 * h + xx] = e;
                dss[col * DSS + kg * 16 + g + 8 * h] = e;
              }
            }
        }
        __syncthreads();  // e^T is staged
        if (forms_dv) {  // dV += e^T.dO'
          add_product_tf32x3<BQ, D, RF>(
              acc[0], x, reinterpret_cast<const float*>(dot),
              reinterpret_cast<const float*>(dols), lane);
        } else {  // dS^T = e^T (dP^T - delta'), staged; dK += dS^T.Q
#pragma unroll
          for (int n = 0; n < NQ; ++n)
#pragma unroll
            for (int xx = 0; xx < 2; ++xx) {
              const int col = n * 8 + 2 * tq + xx, qr = q0 + col;
              const float dlt = dl[col];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                bool keep = whole;
                if (!whole) {
                  keep = key_ok[h] && qr < p.seq_q;
                  if (p.causal) keep = keep && keys[h] <= qr + diff;
                }
                float* at = dss + col * DSS + kg * 16 + g + 8 * h;
                const float ds = keep ? *at * (x[n][2 * h + xx] - dlt) : 0.f;
                x[n][2 * h + xx] = ds;
                if constexpr (DQ) *at = ds;
              }
            }
          add_product_tf32x3<BQ, D, RF>(
              acc[0], x, reinterpret_cast<const float*>(qt),
              reinterpret_cast<const float*>(qls), lane);
        }
      } else {
        // S^T = K.Q^T, dP^T = V.dO'^T: K's and V's A fragments, and x4
        // ldmatrix of Q / dO' hi and lo (the B fragments of 2 n8 tiles)
        float s[NQ][4], dp[NQ][4];
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int st = 0; st < D / 8; ++st) {
          uint32_t kh[4], kl[4], va[4], vh[4], vl[4];
          const int arow =
              (kg * 16 + (lane & 15)) * RS + st * 32 + (lane >> 4) * 16;
          if constexpr (DQ) {
            ldmatrix_x4(kh, ks + arow);
            ldmatrix_x4(kl, kls + arow);
          } else {
            uint32_t ka[4];
            ldmatrix_x4(ka, ks + arow);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              split_tf32(__uint_as_float(ka[i]), kh[i], kl[i]);
          }
          ldmatrix_x4(va, vs + arow);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32(__uint_as_float(va[i]), vh[i], vl[i]);
#pragma unroll
          for (int j = 0; j < NQ / 2; ++j) {
            const int brow = (j * 16 + (lane & 7) + (lane >> 4) * 8) * RS +
                             st * 32 + ((lane >> 3) & 1) * 16;
            uint32_t bh[4], bl[4];
            ldmatrix_x4(bh, qt + brow);
            ldmatrix_x4(bl, qls + brow);
            mma_tf32x3(s[2 * j], kh, kl, bh[0], bh[1], bl[0], bl[1]);
            mma_tf32x3(s[2 * j + 1], kh, kl, bh[2], bh[3], bl[2], bl[3]);
            ldmatrix_x4(bh, dot + brow);
            ldmatrix_x4(bl, dols + brow);
            mma_tf32x3(dp[2 * j], vh, vl, bh[0], bh[1], bl[0], bl[1]);
            mma_tf32x3(dp[2 * j + 1], vh, vl, bh[2], bh[3], bl[2], bl[3]);
          }
        }

        // e^T into s, dS^T into dp, in the C layout: entry (n, 2h + x) is
        // key keys[h], query q0 + 8n + 2tq + x; the masks skipped on whole
        // tiles, as in dkdv_mma_kernel
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int col = n * 8 + 2 * tq + x, qr = q0 + col;
            const float dlt = dl[col];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float lg = s[n][2 * h + x] * p.c;
              if (has_bias) lg += bt[col * L::BS + 8 * h] * LOG2E;
              float e, ds;
              if (whole) {
                e = exp2f(lg);
                ds = e * (dp[n][2 * h + x] - dlt);
              } else {
                bool keep = key_ok[h] && qr < p.seq_q;
                if (p.causal) keep = keep && keys[h] <= qr + diff;
                e = keep ? exp2f(lg) : 0.f;
                ds = keep ? e * (dp[n][2 * h + x] - dlt) : 0.f;
              }
              s[n][2 * h + x] = e;
              dp[n][2 * h + x] = ds;
              // K2: stage dS (queries x keys) for dQ = dS.K
              if constexpr (DQ) dss[col * DSS + kg * 16 + g + 8 * h] = ds;
            }
          }

        // dV += e^T.dO', then dK += dS^T.Q, e and dS in f32 (split hi /
        // lo): their C fragments are the A fragments, dO' and Q rows read
        // in the matching order
        add_product_tf32x3<BQ, D, RF>(
            acc[0], s, reinterpret_cast<const float*>(dot),
            reinterpret_cast<const float*>(dols), lane);
        add_product_tf32x3<BQ, D, RF>(
            acc[1], dp, reinterpret_cast<const float*>(qt),
            reinterpret_cast<const float*>(qls), lane);
      }

      if constexpr (DQ) {
        // dQ rows of this tile += dS.K over the block's BK keys: warp w takes
        // query group w % QG and head-dim part w / QG.  A lane's float2 reads
        // of dS rows g and g + 8 at keys 8kk + 2tq are dS's C fragment of
        // that k8 step, fed to add_product_tf32x3 as an A fragment
        __syncthreads();  // every warp's dS is staged
        const int qg = warp % QG, dpart = warp / QG;
        float* dqb = p.dq_acc + qrow0 * D;
#pragma unroll
        for (int hp = 0; hp < NH; ++hp) {
          const int c0 = (dpart * NDQ + hp * NDH) * 8;  // the pass's columns
          float dq[NDH][4];
#pragma unroll
          for (int n = 0; n < NDH; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk) {
            const float* row = dss + (qg * 16 + g) * DSS + kk * 8 + 2 * tq;
            const float2 r0 = *reinterpret_cast<const float2*>(row);
            const float2 r8 = *reinterpret_cast<const float2*>(row + 8 * DSS);
            const float cf[1][4] = {{r0.x, r0.y, r8.x, r8.y}};
            const int at = kk * 8 * RF + c0;
            add_product_tf32x3<8, NDH * 8, RF>(dq, cf, kf + at, klf + at, lane);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = q0 + qg * 16 + g + 8 * h;
            if (row >= p.seq_q) continue;
#pragma unroll
            for (int n = 0; n < NDH; ++n)
              atomicAdd(reinterpret_cast<float2*>(
                            dqb + size_t(row) * D + c0 + n * 8 + 2 * tq),
                        make_float2(dq[n][2 * h], dq[n][2 * h + 1]));
          }
        }
      }
      __syncthreads();  // the next tile's loads, splits, dS and bias may
                        // overwrite
    }
    close_chain();
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Tensor-core dQ / dB kernel (bf16): K3a.  Grid (query tiles, H, B), query
// tiles heaviest first; DQ_NT threads, warp w owning queries q0 + 16w ..

constexpr int DQ_BQ = 64;   // queries per block
constexpr int DQ_NT = 128;  // threads: 4 warps

// K3a's dS and dB step (dq_mma_kernel, dq_tf32_kernel): dS into dp, in the
// C layout of the warp's (16 x 8 NS) tile: entry (n, 2h + x) is query
// rows[h], key k0 + 8n + 2tq + x.  A tile whose every (query, key) pair is
// visible (no key mask, inside both lengths and the causal diagonal) skips
// the masks; hidden entries are selected to exact 0.  The bias comes from
// its staged f32 tile (bt: this thread's row g and column 2tq, rows BS
// floats apart; nullptr without a bias), added to the logit in f32.  Each
// (row, key pair) adds its two dS to dB (db: the head's slice) at once, as
// a float2 where a row's entries pair up 8-byte aligned (even seq_k: the
// tile columns 2tq are even), else as scalars
template <int NS, int BS>
__device__ __forceinline__ void dq_ds_db(const Params& p, const float (&s)[NS][4],
                                         float (&dp)[NS][4],
                                         const int (&rows)[2],
                                         const float (&dlt)[2], const float* bt,
                                         const uint8_t* mb, float* db, int q0,
                                         int k0, int tq) {
  constexpr int BK = 8 * NS;
  const int diff = p.seq_k - p.seq_q;
  const bool whole = mb == nullptr && k0 + BK <= p.seq_k &&
                     q0 + DQ_BQ <= p.seq_q &&
                     (!p.causal || k0 + BK - 1 <= q0 + diff);
  const bool db2 = p.seq_k % 2 == 0;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = k0 + n * 8 + 2 * tq;
      float2 bv = make_float2(0.f, 0.f);
      if (bt != nullptr)
        bv = *reinterpret_cast<const float2*>(bt + 8 * h * BS + n * 8);
      float ds[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float lg = s[n][2 * h + x] * p.c + (x ? bv.y : bv.x) * LOG2E;
        bool keep = true;
        if (!whole) {
          const int c = col + x;
          keep = rows[h] < p.seq_q && c < p.seq_k;
          if (p.causal) keep = keep && c <= rows[h] + diff;
          if (mb != nullptr) keep = keep && mb[min(c, p.seq_k - 1)] != 0;
        }
        ds[x] = keep ? exp2f(lg) * (dp[n][2 * h + x] - dlt[h]) : 0.f;
        dp[n][2 * h + x] = ds[x];
      }
      if (db != nullptr && (ds[0] != 0.f || ds[1] != 0.f)) {
        float* at = db + size_t(rows[h]) * p.seq_k + col;
        if (db2 && col + 1 < p.seq_k) {
          atomicAdd(reinterpret_cast<float2*>(at), make_float2(ds[0], ds[1]));
        } else {
          if (ds[0] != 0.f) atomicAdd(at, ds[0]);
          if (ds[1] != 0.f) atomicAdd(at + 1, ds[1]);
        }
      }
    }
}

template <int D>
struct DqLayout {
  static constexpr int BK = D > 128 ? 32 : 64;   // keys per tile
  static constexpr int RS = 2 * D + 16;           // bf16 row stride, bytes
  static constexpr int BS = BK + 8;               // bias row stride, floats:
                                                  // rows 8 banks apart, so a
                                                  // half warp's float2 reads
                                                  // hit 32 distinct banks
  static constexpr size_t QT = size_t(DQ_BQ) * RS;  // the Q or dO' tile
  static constexpr size_t KT = size_t(BK) * RS;     // one K or V tile
  // Q, dO'; two K and two V tiles; then two bias tiles (64 queries x BK
  // keys, f32)
  static constexpr size_t BASE = 2 * QT + 4 * KT;
  static constexpr size_t BIAS = 2 * size_t(DQ_BQ) * BS * sizeof(float);
};

// T: __nv_bfloat16 (q, k, v, dO' and dQ)
template <typename T, int D>
__global__ void __launch_bounds__(DQ_NT, 1) dq_mma_kernel(Params p) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 operands");
  using L = DqLayout<D>;
  constexpr int BK = L::BK, RS = L::RS, BS = L::BS;
  constexpr int NS = BK / 8;       // n8 tiles of a warp's (16 x BK) S tile
  constexpr int ND = D / 8;        // n8 tiles of dQ
  constexpr int KSTEPS = D / 16;   // k16 steps of S and dP'
  constexpr bool QREG = D <= 64;   // Q's and dO''s A fragments in registers
  extern __shared__ __align__(16) unsigned char msmem[];
  unsigned char* qs = msmem;
  unsigned char* dos = qs + L::QT;
  unsigned char* ks = dos + L::QT;       // 2 buffers
  unsigned char* vs = ks + 2 * L::KT;    // 2 buffers
  float* bss = reinterpret_cast<float*>(vs + 2 * L::KT);  // 2 bias tiles

  const int bi = blockIdx.z, hi = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_BQ;  // heaviest first
  const int kvhi = hi / (p.H / p.KVH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int diff = p.seq_k - p.seq_q;
  const size_t qrow0 = (size_t(bi) * p.H + hi) * p.seq_q;
  const size_t kvrow0 = (size_t(bi) * p.KVH + kvhi) * p.seq_k;
  const uint8_t* mb = p.mask ? p.mask + size_t(bi) * p.seq_k : nullptr;
  const size_t bslice = size_t(p.bias_batch_dim ? bi : hi) * p.seq_q * p.seq_k;
  const float* bb = p.bias ? p.bias + bslice : nullptr;
  float* db = p.db ? p.db + bslice : nullptr;

  // keys this block can see: all, or (causal) up to its last row's diagonal
  const int last_row = min(q0 + DQ_BQ, p.seq_q) - 1;
  const int kend = p.causal ? max(0, min(p.seq_k, last_row + diff + 1)) : p.seq_k;
  const int nk = (kend + BK - 1) / BK;

  const bool bias16 =
      p.seq_k % 4 == 0 && reinterpret_cast<uintptr_t>(p.bias) % 16 == 0;
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    load_rows<2 * D, RS, DQ_NT>(ks + buf * L::KT,
                                static_cast<const T*>(p.k) + kvrow0 * D, k0,
                                BK, p.seq_k);
    load_rows<2 * D, RS, DQ_NT>(vs + buf * L::KT,
                                static_cast<const T*>(p.v) + kvrow0 * D, k0,
                                BK, p.seq_k);
    if (bb != nullptr)
      load_bias_tile<DQ_NT>(bss + buf * DQ_BQ * BS,
                            bb + size_t(q0) * p.seq_k + k0, DQ_BQ, BK,
                            p.seq_q - q0, p.seq_k - k0, p.seq_k, BS, bias16);
  };
  if (nk > 0) {
    load_rows<2 * D, RS, DQ_NT>(qs, static_cast<const T*>(p.q) + qrow0 * D,
                                q0, DQ_BQ, p.seq_q);
    load_rows<2 * D, RS, DQ_NT>(dos, static_cast<const T*>(p.dO) + qrow0 * D,
                                q0, DQ_BQ, p.seq_q);
    load_kv(0, 0);
  }
  cp_async_commit();

  // this thread's query rows: C rows g and g + 8 of the warp's 16
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    dlt[h] = rows[h] < p.seq_q ? p.delta[qrow0 + rows[h]] : 0.f;

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  uint32_t qf[QREG ? KSTEPS : 1][4], df[QREG ? KSTEPS : 1][4];
  const int arow = (warp * 16 + (lane & 15)) * RS + (lane >> 4) * 16;

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1, k0 = kt * BK;
    if (kt + 1 < nk) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt (and, at kt 0, Q and dO') has landed
    if constexpr (QREG) {
      if (kt == 0) {
#pragma unroll
        for (int st = 0; st < KSTEPS; ++st) {
          ldmatrix_x4(qf[st], qs + arow + st * 32);
          ldmatrix_x4(df[st], dos + arow + st * 32);
        }
      }
    }
    const unsigned char* kt_s = ks + buf * L::KT;
    const unsigned char* vt_s = vs + buf * L::KT;

    // S = Q.K^T, dP' = dO'.V^T: an x4 ldmatrix of K / V gives the B
    // fragments of 2 n8 tiles
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int st = 0; st < KSTEPS; ++st) {
      uint32_t qa[4], da[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = qf[st][i];
          da[i] = df[st][i];
        }
      } else {
        ldmatrix_x4(qa, qs + arow + st * 32);
        ldmatrix_x4(da, dos + arow + st * 32);
      }
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        const int brow = (j * 16 + (lane & 7) + (lane >> 4) * 8) * RS +
                         st * 32 + ((lane >> 3) & 1) * 16;
        uint32_t b[4];
        ldmatrix_x4(b, kt_s + brow);
        mma_bf16(s[2 * j], qa, b[0], b[1]);
        mma_bf16(s[2 * j + 1], qa, b[2], b[3]);
        ldmatrix_x4(b, vt_s + brow);
        mma_bf16(dp[2 * j], da, b[0], b[1]);
        mma_bf16(dp[2 * j + 1], da, b[2], b[3]);
      }
    }

    // dS into dp, and its adds to dB (dq_ds_db)
    dq_ds_db<NS, BS>(p, s, dp, rows, dlt,
                     bb != nullptr ? bss + buf * DQ_BQ * BS +
                                         (warp * 16 + g) * BS + 2 * tq
                                   : nullptr,
                     mb, db, q0, k0, tq);

    // dQ += dS.K: dS's C fragments are its A fragments (hi and lo), K is
    // read by ldmatrix.trans
    add_product<BK, D, RS>(dq, dp, kt_s, lane);
    __syncthreads();  // the next tile's loads may overwrite this buffer
  }
  cp_async_wait<0>();

  T* dqb = static_cast<T*>(p.dq) + qrow0 * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= p.seq_q) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dqb + size_t(rows[h]) * D + n * 8 + 2 * tq) =
          pack_bf16(dq[n][2 * h] * p.scale, dq[n][2 * h + 1] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core f32 K3a (3xTF32): dq_mma_kernel's grid (query tiles heaviest
// first) and block (DQ_NT threads, warp w owning queries q0 + 16w ..),
// every product as three tf32 mma.sync passes.

template <int D>
struct DqTf32Layout {
  static constexpr bool WIDE = D > 128;
  // keys a tile: 32 from d 64 (64-key tiles would take 136 KB at d 64,
  // one block an SM; 32-key tiles keep two, with or without a bias), 16
  // at d 256
  static constexpr int BK = D <= 32 ? 64 : D <= 192 ? 32 : 16;
  // f32 rows of D + 4 floats, as in Tf32Layout: ldmatrix rows hit 8
  // banks, add_product_tf32x3's two rows 8 banks apart
  static constexpr int RF = D + 4;
  static constexpr int RS = 4 * RF;
  static constexpr int BS = BK + 8;  // bias row stride, floats (DqLayout's)
  static constexpr size_t QT = size_t(DQ_BQ) * RS;  // the Q or dO' tile
  static constexpr size_t KT = size_t(BK) * RS;     // one K or V tile
  // Q, dO' (split at each fragment load: a warp reads its own rows); two
  // K and two V tiles (up to d 128 each split in place into its hi, the
  // current K and V tiles' lo beside; above, where Q and dO' take 133 KB
  // at d 256, split at each fragment load); then two bias tiles (64
  // queries x BK keys, f32)
  static constexpr size_t BASE = 2 * QT + (WIDE ? 4 : 6) * KT;
  static constexpr size_t BIAS = 2 * size_t(DQ_BQ) * BS * sizeof(float);
};

// t (a warp's 16 x 8 NS tile, C fragments) = A.B^T over KS k steps of 8
// floats, 3xTF32 (dq_tf32_kernel above d 128, and the wide route's f32
// kernels over a chunk): A the warp's 16 rows and B's 8 NS rows in shared
// memory (x4 ldmatrix at `a` and `b`, this lane's row and byte offset, B's
// rows `bstride` bytes apart), both split as they are read.  hi.hi and
// the small terms lo.hi + hi.lo sum apart, each in two accumulators by the
// k step's parity: four chains of dependent mma a quarter as long, and as
// many fewer roundings toward zero on each (dP' sums d terms of one sign
// where v and dO' share it, and dS takes the difference of two such sums)
template <int NS, int KS>
__device__ __forceinline__ void scores_tf32x3(float (&t)[NS][4],
                                              const unsigned char* a,
                                              const unsigned char* b,
                                              int bstride) {
  float hh[2][NS][4], sm[2][NS][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) hh[r][n][e] = sm[r][n][e] = 0.f;
#pragma unroll
  for (int st = 0; st < KS; ++st) {
    uint32_t x[4], ah[4], al[4];
    ldmatrix_x4(x, a + st * 32);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), ah[i], al[i]);
    const int r = st & 1;
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) {
      uint32_t bh[4], bl[4];
      ldmatrix_x4(x, b + j * 16 * bstride + st * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(__uint_as_float(x[i]), bh[i], bl[i]);
      mma_tf32(sm[r][2 * j], al, bh[0], bh[1]);
      mma_tf32(sm[r][2 * j], ah, bl[0], bl[1]);
      mma_tf32(hh[r][2 * j], ah, bh[0], bh[1]);
      mma_tf32(sm[r][2 * j + 1], al, bh[2], bh[3]);
      mma_tf32(sm[r][2 * j + 1], ah, bl[2], bl[3]);
      mma_tf32(hh[r][2 * j + 1], ah, bh[2], bh[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      t[n][e] = (hh[0][n][e] + hh[1][n][e]) + (sm[0][n][e] + sm[1][n][e]);
}

template <int D>
__global__ void __launch_bounds__(DQ_NT, 1) dq_tf32_kernel(Params p) {
  using L = DqTf32Layout<D>;
  constexpr int BK = L::BK, RS = L::RS, RF = L::RF, BS = L::BS;
  constexpr bool WIDE = L::WIDE;
  constexpr int NS = BK / 8;  // n8 tiles of a warp's (16 x BK) S tile
  constexpr int ND = D / 8;   // n8 tiles of dQ
  extern __shared__ __align__(16) unsigned char msmem[];
  unsigned char* qs = msmem;
  unsigned char* dos = qs + L::QT;
  unsigned char* ks = dos + L::QT;       // 2 buffers
  unsigned char* vs = ks + 2 * L::KT;    // 2 buffers
  unsigned char* kls = vs + 2 * L::KT;   // up to d 128: the current tiles' lo
  unsigned char* vls = kls + L::KT;
  float* bss = reinterpret_cast<float*>(kls + (WIDE ? 0 : 2) * L::KT);

  const int bi = blockIdx.z, hi = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_BQ;  // heaviest first
  const int kvhi = hi / (p.H / p.KVH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int diff = p.seq_k - p.seq_q;
  const size_t qrow0 = (size_t(bi) * p.H + hi) * p.seq_q;
  const size_t kvrow0 = (size_t(bi) * p.KVH + kvhi) * p.seq_k;
  const uint8_t* mb = p.mask ? p.mask + size_t(bi) * p.seq_k : nullptr;
  const size_t bslice = size_t(p.bias_batch_dim ? bi : hi) * p.seq_q * p.seq_k;
  const float* bb = p.bias ? p.bias + bslice : nullptr;
  float* db = p.db ? p.db + bslice : nullptr;

  // keys this block can see: all, or (causal) up to its last row's diagonal
  const int last_row = min(q0 + DQ_BQ, p.seq_q) - 1;
  const int kend = p.causal ? max(0, min(p.seq_k, last_row + diff + 1)) : p.seq_k;
  const int nk = (kend + BK - 1) / BK;

  const bool bias16 =
      p.seq_k % 4 == 0 && reinterpret_cast<uintptr_t>(p.bias) % 16 == 0;
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    load_rows<4 * D, RS, DQ_NT>(ks + buf * L::KT,
                                static_cast<const float*>(p.k) + kvrow0 * D,
                                k0, BK, p.seq_k);
    load_rows<4 * D, RS, DQ_NT>(vs + buf * L::KT,
                                static_cast<const float*>(p.v) + kvrow0 * D,
                                k0, BK, p.seq_k);
    if (bb != nullptr)
      load_bias_tile<DQ_NT>(bss + buf * DQ_BQ * BS,
                            bb + size_t(q0) * p.seq_k + k0, DQ_BQ, BK,
                            p.seq_q - q0, p.seq_k - k0, p.seq_k, BS, bias16);
  };
  if (nk > 0) {
    load_rows<4 * D, RS, DQ_NT>(qs, static_cast<const float*>(p.q) + qrow0 * D,
                                q0, DQ_BQ, p.seq_q);
    load_rows<4 * D, RS, DQ_NT>(dos,
                                static_cast<const float*>(p.dO) + qrow0 * D,
                                q0, DQ_BQ, p.seq_q);
    load_kv(0, 0);
  }
  cp_async_commit();

  // this thread's query rows: C rows g and g + 8 of the warp's 16
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    dlt[h] = rows[h] < p.seq_q ? p.delta[qrow0 + rows[h]] : 0.f;
  // the lane's A row (Q, dO') and B rows (K, V: x4 ldmatrix of 2 n8 tiles)
  const int arow = (warp * 16 + (lane & 15)) * RS + (lane >> 4) * 16;
  const int brow = ((lane & 7) + (lane >> 4) * 8) * RS + ((lane >> 3) & 1) * 16;

  // dQ sums every visible key, each mma rounding its sum toward zero.
  // Every CHAIN tiles (256 keys) the chain is closed and dq restarts from
  // 0: up to d 128 it is added, to nearest, into dQ's running sum dqs
  // (registers); above, where dq alone takes D / 2 registers a thread, into
  // the thread's own dQ words in global memory (scaled), as K2 closes dK
  // and dV
  constexpr int CHAIN = 256 / BK;
  float dq[ND][4], dqs[WIDE ? 1 : ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  if constexpr (!WIDE) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqs[n][e] = 0.f;
  }
  float* const dqh = static_cast<float*>(p.dq) + qrow0 * D;
  bool stored = false;
  auto close_chain = [&]() {
    close_chain_rows(dq, dqh, rows, p.seq_q, D, ND, p.scale, stored, tq);
    stored = true;
  };

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1, k0 = kt * BK;
    if (kt + 1 < nk) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt (and, at kt 0, Q and dO') has landed
    unsigned char* kt_s = ks + buf * L::KT;
    unsigned char* vt_s = vs + buf * L::KT;
    if constexpr (!WIDE) {
      // every warp reads all of K and V: split them once, for the block
      split_rows<D, RS, DQ_NT>(kt_s, kls, BK);
      split_rows<D, RS, DQ_NT>(vt_s, vls, BK);
      __syncthreads();  // the tiles' hi and lo are in place
    }

    // S = Q.K^T, dP' = dO'.V^T: the warp's Q and dO' A fragments split as
    // they are read
    float s[NS][4], dp[NS][4];
    if constexpr (WIDE) {  // K and V split as they are read too
      scores_tf32x3<NS, D / 8>(s, qs + arow, kt_s + brow, RS);
      scores_tf32x3<NS, D / 8>(dp, dos + arow, vt_s + brow, RS);
    } else {
      // x4 ldmatrix of K / V hi and lo give the B fragments of 2 n8 tiles
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int st = 0; st < D / 8; ++st) {
        uint32_t qa[4], da[4], qh[4], ql[4], dh[4], dl[4];
        ldmatrix_x4(qa, qs + arow + st * 32);
        ldmatrix_x4(da, dos + arow + st * 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split_tf32(__uint_as_float(qa[i]), qh[i], ql[i]);
          split_tf32(__uint_as_float(da[i]), dh[i], dl[i]);
        }
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          const int at = brow + j * 16 * RS + st * 32;
          uint32_t bh[4], bl[4];
          ldmatrix_x4(bh, kt_s + at);
          ldmatrix_x4(bl, kls + at);
          mma_tf32x3(s[2 * j], qh, ql, bh[0], bh[1], bl[0], bl[1]);
          mma_tf32x3(s[2 * j + 1], qh, ql, bh[2], bh[3], bl[2], bl[3]);
          ldmatrix_x4(bh, vt_s + at);
          ldmatrix_x4(bl, vls + at);
          mma_tf32x3(dp[2 * j], dh, dl, bh[0], bh[1], bl[0], bl[1]);
          mma_tf32x3(dp[2 * j + 1], dh, dl, bh[2], bh[3], bl[2], bl[3]);
        }
      }
    }

    // dS into dp (the bias added in f32, never split), and its adds to dB
    dq_ds_db<NS, BS>(p, s, dp, rows, dlt,
                     bb != nullptr ? bss + buf * DQ_BQ * BS +
                                         (warp * 16 + g) * BS + 2 * tq
                                   : nullptr,
                     mb, db, q0, k0, tq);

    // dQ += dS.K with dS in f32 (split hi / lo in registers): the C
    // fragment of S holds keys 2q and 2q + 1, which serve as the tf32 A
    // fragment's k indices q and q + 4 when K's rows are read in that
    // order (add_product_tf32x3), so dS is never staged
    const float* kf = reinterpret_cast<const float*>(kt_s);
    if constexpr (WIDE)
      add_product_tf32x3<BK, D, RF>(dq, dp, kf, lane);
    else
      add_product_tf32x3<BK, D, RF>(
          dq, dp, kf, reinterpret_cast<const float*>(kls), lane);
    __syncthreads();  // the next tile's loads and splits may overwrite these
    if ((kt + 1) % CHAIN == 0) {
      if constexpr (WIDE) {
        if (kt + 1 < nk) close_chain();
      } else {
#pragma unroll
        for (int n = 0; n < ND; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dqs[n][e] += dq[n][e];
            dq[n][e] = 0.f;
          }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (WIDE) {
    close_chain();  // the last chain, or (no key visible) zeros
  } else {
    float* dqb = static_cast<float*>(p.dq) + qrow0 * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] >= p.seq_q) continue;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(dqb + size_t(rows[h]) * D + n * 8 + 2 * tq) =
            make_float2((dqs[n][2 * h] + dq[n][2 * h]) * p.scale,
                        (dqs[n][2 * h + 1] + dq[n][2 * h + 1]) * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// The wide route: d a multiple of WCOL past 256, each block owning 256
// output columns (a 128-column remainder at d 384 or 1152)

constexpr int WCOL = 128;  // d's padding unit (ops/blocks.py WIDE_CHUNK)

// ---------------------------------------------------------------------------
// Wide route's dK/dV kernel on the tensor cores (bf16): K2 (DQ = true) and
// K3b (DQ = false), d a multiple of WCOL past 256.  Grid (KVH, B x column
// blocks of XCOL, key tiles), key tiles slowest; XNT threads: warp w (key
// group w % 4, keys k0 + 16 (w % 4) ..) forms S^T, e^T and dV += e^T.dO'
// for w < 4, dP^T, dS^T and dK += dS^T.Q for w >= 4.

constexpr int XCOL = 256;           // dK, dV columns of a block: 16 keys x
                                    // 256 f32 are 128 registers a thread
constexpr int XNT = 256;            // threads: 8 warps
constexpr int XBQ = 32;             // queries a tile
constexpr int XCB = 256;            // bytes of a K, V, Q or dO' row chunk
constexpr int XCS = XCB + 16;       // its shared row stride (17 units)
constexpr int XVS = 2 * XCOL + 16;  // column tile row stride (33 units)
constexpr int XSS = 2 * XBQ + 16;   // dS^T row stride, bytes (5 units)
constexpr int XBS = MBK + 4;        // bias row stride, floats
constexpr size_t XSTAGE = size_t(2 * MBK + 2 * XBQ) * XCS;  // K, V, Q, dO'
constexpr size_t XCOLT = size_t(XBQ) * XVS;  // a Q or dO' column tile
struct XLayout {
  // two chunk stages; two (Q, dO') column tile pairs; e^T as C fragments;
  // two delta' rows; then K2's K column tile and dS^T hi and lo tiles, or
  // K3b's two bias tiles (XBQ queries x 64 keys, f32)
  static constexpr size_t CHUNKS = 0;
  static constexpr size_t COLS = CHUNKS + 2 * XSTAGE;
  static constexpr size_t ES = COLS + 4 * XCOLT;
  static constexpr size_t DL = ES + sizeof(float) * MBK * XBQ;
  static constexpr size_t TAIL = DL + 2 * sizeof(float) * XBQ;
  static constexpr size_t K2 = TAIL + size_t(MBK) * XVS + 2 * size_t(MBK) * XSS;
  static constexpr size_t K3 = TAIL;
  static constexpr size_t BIAS = 2 * sizeof(float) * XBQ * XBS;
};
static_assert(XLayout::K2 <= 232448 && XLayout::K3 + XLayout::BIAS <= 232448,
              "the wide dK/dV kernel's shared memory fits a block");

// acc (16 x 8 NA, C fragments) += c . src over the first nd16 16-column
// pairs, c a (16 x N) f32 tile in C fragments fed as bf16 hi + lo A
// fragments, src an (N x *) bf16 tile, rows RS bytes apart (ldmatrix.trans)
template <int N, int RS, int NA>
__device__ __forceinline__ void add_product_cols(float (&acc)[NA][4],
                                                 const float (&c)[N / 8][4],
                                                 const unsigned char* src,
                                                 int lane, int nd16) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    uint32_t ah[4], al[4];
    split_a(c, j, ah, al);
#pragma unroll
    for (int dn = 0; dn < NA / 2; ++dn) {
      if (dn >= nd16) break;
      uint32_t b[4];
      ldmatrix_x4_trans(b, src + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                               (dn * 16 + (lane >> 4) * 8) * 2);
      mma_bf16(acc[2 * dn], ah, b[0], b[1]);
      mma_bf16(acc[2 * dn], al, b[0], b[1]);
      mma_bf16(acc[2 * dn + 1], ah, b[2], b[3]);
      mma_bf16(acc[2 * dn + 1], al, b[2], b[3]);
    }
  }
}

// `bytes` from byte `off` of global rows [first, first + nrows), `ld` bytes
// apart (rows past `limit` as zeros), to shared rows `stride` apart, by the
// block's NTH threads
template <int NTH>
__device__ __forceinline__ void load_row_part(unsigned char* dst,
                                              const unsigned char* src,
                                              int first, int nrows, int limit,
                                              int ld, int off, int bytes,
                                              int stride) {
  const int chunks = bytes / 16;
  for (int idx = threadIdx.x; idx < nrows * chunks; idx += NTH) {
    const int r = idx / chunks, cc = (idx % chunks) * 16, row = first + r;
    const bool in = row < limit;
    cp_async16(dst + r * stride + cc,
               in ? src + size_t(row) * ld + off + cc : src, in ? 16 : 0);
  }
}

template <bool DQ>
__global__ void __launch_bounds__(XNT, 1) dkdv_wide_mma_kernel(Params p, int d) {
  using T = __nv_bfloat16;
  using L = XLayout;
  constexpr int NQ = XBQ / 8;      // n8 tiles of a warp's (16 keys x XBQ) tile
  constexpr int ND = XCOL / 8;     // n8 tiles of its dK or dV columns
  constexpr int QG = XBQ / 16;     // dQ: 16-query groups of a tile ...
  constexpr int DPN = (XNT / 32) / QG;  // ... and the column parts per group
  extern __shared__ __align__(16) unsigned char msmem[];
  unsigned char* colt = msmem + L::COLS;               // 2 x (Q, dO') tiles
  float* es = reinterpret_cast<float*>(msmem + L::ES);  // e^T fragments
  float* dls = reinterpret_cast<float*>(msmem + L::DL);  // 2 x XBQ
  unsigned char* kcol = msmem + L::TAIL;               // K2: K[keys, cols]
  unsigned char* dss = kcol + size_t(MBK) * XVS;       // K2: dS^T hi, lo
  float* bss = reinterpret_cast<float*>(msmem + L::TAIL);  // K3b: 2 bias tiles

  const int ncb = (d + XCOL - 1) / XCOL;
  const int kvhi = blockIdx.x, bi = blockIdx.y / ncb;
  const int c0 = (blockIdx.y % ncb) * XCOL;
  const int ncols = min(XCOL, d - c0);
  const int k0 = blockIdx.z * MBK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int kg = warp & 3;                // the warp's 16 keys
  const bool forms_dv = warp < 4;         // warp-uniform roles
  const int G = p.H / p.KVH, diff = p.seq_k - p.seq_q;
  const int RB = 2 * d;                   // bytes of a row
  const int nch = RB / XCB;               // chunks of it
  const size_t kvrow0 = (size_t(bi) * p.KVH + kvhi) * p.seq_k;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(
      static_cast<const T*>(p.k) + kvrow0 * d);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(
      static_cast<const T*>(p.v) + kvrow0 * d);
  const uint8_t* mb = p.mask ? p.mask + size_t(bi) * p.seq_k : nullptr;

  // (head, q tile) pairs that see the block's keys: the causal start is the
  // first query row that sees key k0
  const int qfirst = p.causal ? max(0, k0 - diff) : 0;
  const int qt0 = qfirst / XBQ;
  const int per_head = max(0, (p.seq_q + XBQ - 1) / XBQ - qt0);
  const int total = G * per_head;
  const int steps = total * nch;  // (pair, chunk), chunks fastest

  auto q_rows = [&](int it) {  // the query rows' first index, (b, h, 0)
    return (size_t(bi) * p.H + kvhi * G + it / per_head) * p.seq_q;
  };
  const bool bias16 =
      p.seq_k % 4 == 0 && reinterpret_cast<uintptr_t>(p.bias) % 16 == 0;
  // step st's K, V, Q and dO' chunks into stage st & 1; a pair's first
  // step also brings its Q and dO' column tiles, delta' and bias tile
  auto issue = [&](int st) {
    if (st < steps) {
      const int it = st / nch, ch = st % nch, off = ch * XCB;
      const size_t qrow0 = q_rows(it);
      const int q0 = (qt0 + it % per_head) * XBQ;
      const unsigned char* qb = reinterpret_cast<const unsigned char*>(
          static_cast<const T*>(p.q) + qrow0 * d);
      const unsigned char* dob = reinterpret_cast<const unsigned char*>(
          static_cast<const T*>(p.dO) + qrow0 * d);
      unsigned char* stg = msmem + L::CHUNKS + (st & 1) * XSTAGE;
      load_row_part<XNT>(stg, kb, k0, MBK, p.seq_k, RB, off, XCB, XCS);
      load_row_part<XNT>(stg + MBK * XCS, vb, k0, MBK, p.seq_k, RB, off, XCB,
                         XCS);
      load_row_part<XNT>(stg + 2 * MBK * XCS, qb, q0, XBQ, p.seq_q, RB, off,
                         XCB, XCS);
      load_row_part<XNT>(stg + (2 * MBK + XBQ) * XCS, dob, q0, XBQ, p.seq_q,
                         RB, off, XCB, XCS);
      if (ch == 0) {
        const int buf = it & 1;
        unsigned char* ct = colt + 2 * buf * XCOLT;
        load_row_part<XNT>(ct, qb, q0, XBQ, p.seq_q, RB, 2 * c0, 2 * ncols,
                           XVS);
        load_row_part<XNT>(ct + XCOLT, dob, q0, XBQ, p.seq_q, RB, 2 * c0,
                           2 * ncols, XVS);
        for (int i = tid; i < XBQ; i += XNT) {
          const bool in = q0 + i < p.seq_q;
          cp_async4(dls + buf * XBQ + i, in ? p.delta + qrow0 + q0 + i : p.delta,
                    in ? 4 : 0);
        }
        if (!DQ && p.bias != nullptr) {
          const int hb = p.bias_batch_dim ? bi : kvhi * G + it / per_head;
          load_bias_tile<XNT>(bss + buf * XBQ * XBS,
                              p.bias + (size_t(hb) * p.seq_q + q0) * p.seq_k + k0,
                              XBQ, MBK, p.seq_q - q0, p.seq_k - k0, p.seq_k,
                              XBS, bias16);
        }
      }
    }
    cp_async_commit();
  };

  if (DQ && total > 0)  // K2's dQ products read K[keys, cols]
    load_row_part<XNT>(kcol, kb, k0, MBK, p.seq_k, RB, 2 * c0, 2 * ncols, XVS);
  issue(0);

  float acc[ND][4];  // dV (warps 0-3) or dK (warps 4-7)
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this thread's keys: C rows g and g + 8 of the warp's 16
  const int keys[2] = {k0 + kg * 16 + g, k0 + kg * 16 + g + 8};
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    key_ok[h] = keys[h] < p.seq_k && (mb == nullptr || mb[keys[h]] != 0);
  const bool keys_whole = mb == nullptr && k0 + MBK <= p.seq_k;
  float sc[NQ][4];  // S^T (warps 0-3) or dP^T (warps 4-7), summed over d

  for (int st = 0; st < steps; ++st) {
    issue(st + 1);
    cp_async_wait<1>();
    __syncthreads();  // step st's chunks (and its pair's tiles) have landed
    const int it = st / nch, ch = st % nch, buf = it & 1;
    const unsigned char* stg = msmem + L::CHUNKS + (st & 1) * XSTAGE;
    if (ch == 0) {
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    }
    // S^T += K.Q^T (warps 0-3) or dP^T += V.dO'^T (warps 4-7) over the
    // chunk: an x4 ldmatrix of Q / dO' gives the B fragments of 2 n8 tiles
    {
      const unsigned char* at = stg + (forms_dv ? 0 : MBK * XCS);
      const unsigned char* bt = stg + (2 * MBK + (forms_dv ? 0 : XBQ)) * XCS;
#pragma unroll
      for (int kk = 0; kk < XCB / 32; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, at + (kg * 16 + (lane & 15)) * XCS + kk * 32 +
                           (lane >> 4) * 16);
#pragma unroll
        for (int j = 0; j < NQ / 2; ++j) {
          uint32_t b[4];
          ldmatrix_x4(b, bt + (j * 16 + (lane & 7) + (lane >> 4) * 8) * XCS +
                             kk * 32 + ((lane >> 3) & 1) * 16);
          mma_bf16(sc[2 * j], a, b[0], b[1]);
          mma_bf16(sc[2 * j + 1], a, b[2], b[3]);
        }
      }
    }

    if (ch == nch - 1) {
      const size_t qrow0 = q_rows(it);
      const int q0 = (qt0 + it % per_head) * XBQ;
      const float* dl = dls + buf * XBQ;
      const unsigned char* qct = colt + 2 * buf * XCOLT;
      const unsigned char* doct = qct + XCOLT;
      float* ef = es + kg * NQ * 4 * 32 + lane;  // this lane's e^T entries
      if (forms_dv) {
        // e^T in the C layout: entry (n, 2h + x) is key keys[h], query q0
        // + 8n + 2tq + x.  A tile whose every pair is visible skips the
        // masks; the bias comes from its staged tile
        const bool whole = keys_whole && q0 + XBQ <= p.seq_q &&
                           (!p.causal || k0 + MBK - 1 <= q0 + diff);
        const bool has_bias = !DQ && p.bias != nullptr;
        const float* bt = bss + buf * XBQ * XBS + kg * 16 + g;
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int col = n * 8 + 2 * tq + x, qr = q0 + col;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float lg = sc[n][2 * h + x] * p.c;
              if (has_bias) lg += bt[col * XBS + 8 * h] * LOG2E;
              bool keep = true;
              if (!whole) {
                keep = key_ok[h] && qr < p.seq_q;
                if (p.causal) keep = keep && keys[h] <= qr + diff;
              }
              const float e = keep ? exp2f(lg) : 0.f;
              sc[n][2 * h + x] = e;
              ef[(n * 4 + 2 * h + x) * 32] = e;
            }
          }
      }
      __syncthreads();  // e^T is staged for the dK warps
      if (!forms_dv) {
        // dS^T = e^T (dP^T - delta'), e^T from the dV warp of these keys
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float dlt = dl[n * 8 + 2 * tq + x];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              sc[n][2 * h + x] =
                  ef[(n * 4 + 2 * h + x) * 32] * (sc[n][2 * h + x] - dlt);
          }
        if constexpr (DQ) {  // stage dS^T (keys x queries) for dQ = dS.K
#pragma unroll
          for (int n = 0; n < NQ; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int at = (kg * 16 + g + 8 * h) * XSS + (n * 8 + 2 * tq) * 2;
              split_bf16(sc[n][2 * h], sc[n][2 * h + 1],
                         *reinterpret_cast<uint32_t*>(dss + at),
                         *reinterpret_cast<uint32_t*>(dss + MBK * XSS + at));
            }
        }
      }
      // dV[:, cols] += e^T.dO'[:, cols], dK[:, cols] += dS^T.Q[:, cols]: n8
      // tiles 2j, 2j + 1 of e^T / dS^T are the A fragments (hi and lo) of
      // k16 step j
      add_product_cols<XBQ, XVS>(acc, sc, forms_dv ? doct : qct, lane,
                                 ncols / 16);

      if constexpr (DQ) {
        // dQ[:, cols] of this tile += dS.K[:, cols] over the block's 64
        // keys: warp w takes query group w % QG and column part w / QG of
        // ncols / DPN columns; dS^T (hi and lo) read by ldmatrix.trans as
        // dS's A fragments, K by ldmatrix.trans
        __syncthreads();  // every dK warp's dS^T is staged
        const int qg = warp % QG, part = warp / QG;
        const int pcols = ncols / DPN, pc0 = part * pcols;
        float* dqb = p.dq_acc + qrow0 * d + c0;
        float dq[XCOL / DPN / 8][4];
#pragma unroll
        for (int n = 0; n < XCOL / DPN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < MBK / 16; ++kk) {
          const int arow = (kk * 16 + (lane & 7) + (lane >> 4) * 8) * XSS +
                           (qg * 16 + ((lane >> 3) & 1) * 8) * 2;
          uint32_t ah[4], al[4];
          ldmatrix_x4_trans(ah, dss + arow);
          ldmatrix_x4_trans(al, dss + MBK * XSS + arow);
#pragma unroll
          for (int dn = 0; dn < XCOL / DPN / 16; ++dn) {
            if (dn * 16 >= pcols) break;
            uint32_t b[4];
            ldmatrix_x4_trans(
                b, kcol + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * XVS +
                       (pc0 + dn * 16 + (lane >> 4) * 8) * 2);
            mma_bf16(dq[2 * dn], ah, b[0], b[1]);
            mma_bf16(dq[2 * dn], al, b[0], b[1]);
            mma_bf16(dq[2 * dn + 1], ah, b[2], b[3]);
            mma_bf16(dq[2 * dn + 1], al, b[2], b[3]);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = q0 + qg * 16 + g + 8 * h;
          if (row >= p.seq_q) continue;
#pragma unroll
          for (int n = 0; n < XCOL / DPN / 8; ++n) {
            if (n * 8 >= pcols) break;
            atomicAdd(reinterpret_cast<float2*>(
                          dqb + size_t(row) * d + pc0 + n * 8 + 2 * tq),
                      make_float2(dq[n][2 * h], dq[n][2 * h + 1]));
          }
        }
      }
    }
    __syncthreads();  // the next steps' loads may overwrite these buffers
  }
  cp_async_wait<0>();

  T* dst = static_cast<T*>(forms_dv ? p.dv : p.dk) + kvrow0 * d + c0;
  const float mul = forms_dv ? 1.f : p.scale;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] >= p.seq_k) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (n * 8 >= ncols) break;
      *reinterpret_cast<uint32_t*>(dst + size_t(keys[h]) * d + n * 8 + 2 * tq) =
          pack_bf16(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// Wide route's dK/dV kernel on the tensor cores in float32 (3xTF32): K2
// (DQ = true) and K3b (DQ = false), d a multiple of WCOL past 256.  Grid
// (KVH, B x column blocks of XCOL, key tiles of ZBK), key tiles slowest;
// ZNT threads: warp w (key group w % 2, keys k0 + 16 (w % 2) ..) forms
// S^T, e^T and dV += e^T.dO' if w % 4 < 2, else dP^T, dS^T and dK +=
// dS^T.Q, summing S^T or dP^T over half w / 4 of every chunk and forming
// its product over that half of the block's columns; K2's eight add
// dS.K[:, cols] to the dQ scratch.

constexpr int ZNT = 256;               // threads: 8 warps
constexpr int ZBK = 32;                // keys a block
constexpr int ZBQ = 32;                // queries a tile
constexpr int ZKC = 64;                // d lanes of a chunk (256 bytes)
constexpr int ZCS = 4 * ZKC + 16;      // its shared row stride (17 units)
constexpr int ZRF = XCOL + 4;          // column tile row stride, floats
constexpr int ZDSS = ZBK + 4;          // e^T and dS staging row stride, floats
constexpr int ZBS = ZBK + 4;           // bias row stride, floats
constexpr int ZSTAGES = 3;             // chunk stages in flight
template <bool DQ>
struct ZLayout {
  // the chunk stages (K's, V's, Q's and dO''s rows); the Q and dO' column
  // tiles (ZBQ queries x the block's columns); K2's K column tile; the e^T
  // staging tile and K2's dS staging tile (queries x keys); the warp
  // pairs' halves of S^T and dP^T (8 warps x their C fragments); two
  // delta' rows; then K3b's two bias tiles (ZBQ queries x ZBK keys, f32)
  static constexpr size_t STAGE = size_t(2 * ZBK + 2 * ZBQ) * ZCS;
  static constexpr size_t QT = size_t(ZBQ) * ZRF * 4;  // a Q or dO' tile
  static constexpr size_t KT = size_t(ZBK) * ZRF * 4;  // K's column tile
  static constexpr size_t ST = size_t(ZBQ) * ZDSS * 4;  // a staging tile
  static constexpr size_t COLS = ZSTAGES * STAGE;
  static constexpr size_t KCOL = COLS + 2 * QT;
  static constexpr size_t ES = KCOL + (DQ ? KT : 0);
  static constexpr size_t DS = ES + ST;
  static constexpr size_t XS = DS + (DQ ? ST : 0);
  static constexpr size_t DL = XS + size_t(ZNT) * (ZBQ / 2) * 4;
  static constexpr size_t BASE = DL + 2 * size_t(ZBQ) * 4;
  static constexpr size_t BIAS = 2 * size_t(ZBQ) * ZBS * 4;
};
static_assert(ZLayout<true>::BASE <= 232448 &&
                  ZLayout<false>::BASE + ZLayout<false>::BIAS <= 232448,
              "the wide f32 K2's and K3b's shared memory");

template <bool DQ>
__global__ void __launch_bounds__(ZNT, 1) dkdv_wide_tf32_kernel(Params p,
                                                                int d) {
  using L = ZLayout<DQ>;
  constexpr int NQ = ZBQ / 8;           // n8 tiles of a warp's (16 keys x ZBQ)
  constexpr int NA = XCOL / 2 / 8;      // n8 tiles of its dK or dV columns
  constexpr int NDQ = XCOL / 4 / 8;     // n8 tiles of a warp's dQ columns
  constexpr int KSTEPS = ZKC / 2 / 8;   // k steps of a warp's half chunk
  extern __shared__ __align__(16) unsigned char msmem[];
  unsigned char* qct = msmem + L::COLS;  // Q[queries, cols]
  unsigned char* doct = qct + L::QT;     // dO'[queries, cols]
  const float* kcf = reinterpret_cast<const float*>(msmem + L::KCOL);
  float* es = reinterpret_cast<float*>(msmem + L::ES);
  float* dss = reinterpret_cast<float*>(msmem + L::DS);
  float* xsh = reinterpret_cast<float*>(msmem + L::XS);
  float* dls = reinterpret_cast<float*>(msmem + L::DL);  // 2 x ZBQ
  float* bss = reinterpret_cast<float*>(msmem + L::BASE);  // K3b: 2 x bias

  const int ncb = (d + XCOL - 1) / XCOL;
  const int kvhi = blockIdx.x, bi = blockIdx.y / ncb;
  const int c0 = (blockIdx.y % ncb) * XCOL;
  const int ncols = min(XCOL, d - c0);  // 256, or 128 (d an odd multiple)
  const int k0 = blockIdx.z * ZBK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int kg = warp & 1;               // the warp's 16 keys
  const bool forms_dv = (warp & 2) == 0;  // warp-uniform roles
  const int pair = warp & 3, half = warp >> 2;
  const int hcols = ncols / 2;           // the warp's dK or dV columns
  const int G = p.H / p.KVH, diff = p.seq_k - p.seq_q;
  const int nch = d / ZKC;               // chunks of a row
  // a tile's chunks run from the one past the block's columns round to
  // them, so the block's own chunks of Q and dO' come last: they land in
  // the column tiles (the products' operands) instead of the ring, and
  // the next tile's own chunks (at least ZSTAGES - 1 steps into it, d
  // being at least 384) arrive after this tile's products are done
  const int nown = ncols / ZKC, ce = c0 / ZKC + nown;
  const size_t kvrow0 = (size_t(bi) * p.KVH + kvhi) * p.seq_k;
  const float* kb = static_cast<const float*>(p.k) + kvrow0 * d;
  const float* vb = static_cast<const float*>(p.v) + kvrow0 * d;
  const uint8_t* mb = p.mask ? p.mask + size_t(bi) * p.seq_k : nullptr;

  // (head, q tile) pairs that see the block's keys: the causal start is the
  // first query row that sees key k0
  const int qfirst = p.causal ? max(0, k0 - diff) : 0;
  const int qt0 = qfirst / ZBQ;
  const int per_head = max(0, (p.seq_q + ZBQ - 1) / ZBQ - qt0);
  const int total = G * per_head;
  const int steps = total * nch;  // (pair, chunk), chunks fastest

  auto q_rows = [&](int it) {  // the query rows' first index, (b, h, 0)
    return (size_t(bi) * p.H + kvhi * G + it / per_head) * p.seq_q;
  };
  // rows [first, first + nrows) of a (*, d) f32 tensor (rows past `limit`
  // as zeros), `n` floats from lane `off` (those past `n_in` as zeros),
  // into shared rows `stride` bytes apart
  auto load = [&](unsigned char* dst, const float* src, int first, int nrows,
                  int limit, int off, int n, int n_in, int stride) {
    const int per_row = n / 4;
    for (int idx = tid; idx < nrows * per_row; idx += ZNT) {
      const int r = idx / per_row, cc = (idx % per_row) * 4, row = first + r;
      const bool in = row < limit && cc < n_in;
      cp_async16(dst + r * stride + cc * 4,
                 in ? src + size_t(row) * d + off + cc : src, in ? 16 : 0);
    }
  };
  const bool bias16 =
      p.seq_k % 4 == 0 && reinterpret_cast<uintptr_t>(p.bias) % 16 == 0;
  // step st's K and V chunks into stage st % ZSTAGES, and its Q and dO'
  // chunks there too, or (the block's own columns) into the column tiles;
  // a pair's first step also brings its delta' and K3b's bias tile
  auto issue = [&](int st) {
    if (st < steps) {
      const int it = st / nch, i = st - it * nch;
      const int off = (ce + i) % nch * ZKC;
      const size_t qrow0 = q_rows(it);
      const int q0 = (qt0 + it % per_head) * ZBQ;
      const float* qb = static_cast<const float*>(p.q) + qrow0 * d;
      const float* dob = static_cast<const float*>(p.dO) + qrow0 * d;
      unsigned char* stg = msmem + (st % ZSTAGES) * L::STAGE;
      load(stg, kb, k0, ZBK, p.seq_k, off, ZKC, ZKC, ZCS);
      load(stg + ZBK * ZCS, vb, k0, ZBK, p.seq_k, off, ZKC, ZKC, ZCS);
      if (i < nch - nown) {
        load(stg + 2 * ZBK * ZCS, qb, q0, ZBQ, p.seq_q, off, ZKC, ZKC, ZCS);
        load(stg + (2 * ZBK + ZBQ) * ZCS, dob, q0, ZBQ, p.seq_q, off, ZKC,
             ZKC, ZCS);
      } else {
        const int at = (off - c0) * 4;
        load(qct + at, qb, q0, ZBQ, p.seq_q, off, ZKC, ZKC, ZRF * 4);
        load(doct + at, dob, q0, ZBQ, p.seq_q, off, ZKC, ZKC, ZRF * 4);
      }
      if (i == 0) {
        for (int r = tid; r < ZBQ; r += ZNT) {
          const bool in = q0 + r < p.seq_q;
          cp_async4(dls + (it & 1) * ZBQ + r,
                    in ? p.delta + qrow0 + q0 + r : p.delta, in ? 4 : 0);
        }
        if (!DQ && p.bias != nullptr) {  // queries q0.., keys k0.., past
                                         // either length as 0
          const int hb = p.bias_batch_dim ? bi : kvhi * G + it / per_head;
          load_bias_tile<ZNT>(
              bss + (it & 1) * ZBQ * ZBS,
              p.bias + (size_t(hb) * p.seq_q + q0) * p.seq_k + k0, ZBQ, ZBK,
              p.seq_q - q0, p.seq_k - k0, p.seq_k, ZBS, bias16);
        }
      }
    }
    cp_async_commit();
  };

  if (DQ && total > 0)  // K2's dQ products read K[keys, cols]
    load(msmem + L::KCOL, kb, k0, ZBK, p.seq_k, c0, XCOL, ncols, ZRF * 4);
#pragma unroll
  for (int st = 0; st < ZSTAGES - 1; ++st) issue(st);

  float acc[NA][4];  // dV or dK over the warp's half of the columns
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this thread's keys: C rows g and g + 8 of the warp's 16
  const int keys[2] = {k0 + kg * 16 + g, k0 + kg * 16 + g + 8};
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    key_ok[h] = keys[h] < p.seq_k && (mb == nullptr || mb[keys[h]] != 0);
  const bool keys_whole = mb == nullptr && k0 + ZBK <= p.seq_k;
  // the warp's A rows (its 16 keys of K or V) in a chunk stage, from its
  // half's first k step; its B rows (Q or dO') from their first
  const int arow = (forms_dv ? 0 : ZBK * ZCS) + (kg * 16 + (lane & 15)) * ZCS +
                   (lane >> 4) * 16 + half * KSTEPS * 32;
  const int brow = ((lane & 7) + (lane >> 4) * 8);
  const int bcol = half * KSTEPS * 32 + ((lane >> 3) & 1) * 16;

  // dK and dV sum G x seq_q queries, each mma rounding its sum toward zero:
  // every CHAIN tiles (256 queries) the chain is closed into the block's
  // own dK or dV rows and the warp's columns in global memory, added to
  // nearest, and the accumulators restart from 0
  constexpr int CHAIN = 256 / ZBQ;
  float* const dst = static_cast<float*>(forms_dv ? p.dv : p.dk) +
                     kvrow0 * d + c0 + half * hcols;
  const float mul = forms_dv ? 1.f : p.scale;
  bool stored = false;
  auto close_chain = [&]() {
    close_chain_rows(acc, dst, keys, p.seq_k, d, hcols / 8, mul, stored, tq);
    stored = true;
  };

  for (int it = 0; it < total; ++it) {
    // S^T (dV warps) or dP^T (dK warps) over the warp's half of d, each
    // chunk's in four accumulators (scores_tf32x3, as dkdv_tf32_kernel's
    // above d 128); every chunk they are closed into xc, added to nearest,
    // so no chain of sums rounded toward zero is longer than a chunk's (a
    // chain over the warp's 256 lanes at d 512 put dq and dk at 9.8e-5 and
    // 8.7e-5 of the float32 bar's 1e-4 over 8192 queries and keys of
    // mean-3 values)
    float xc[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xc[n][e] = 0.f;
    for (int i = 0; i < nch; ++i) {
      const int st = it * nch + i;
      cp_async_wait<ZSTAGES - 2>();
      __syncthreads();  // step st's chunks (and its pair's delta') have
                        // landed, and step st - 1's readers are done
      issue(st + ZSTAGES - 1);  // into step st - 1's stage
      // the warp's own K or V rows split at each fragment load, Q's or
      // dO''s (two warps read each) too; the own chunks' Q and dO' rows
      // from the column tiles
      const unsigned char* stg = msmem + (st % ZSTAGES) * L::STAGE;
      const bool own = i >= nch - nown;
      const unsigned char* bsrc =
          own ? (forms_dv ? qct : doct) + ((ce + i) % nch * ZKC - c0) * 4
              : stg + (2 * ZBK + (forms_dv ? 0 : ZBQ)) * ZCS;
      const int bstride = own ? ZRF * 4 : ZCS;
      float t[NQ][4];
      scores_tf32x3<NQ, KSTEPS>(t, stg + arow, bsrc + brow * bstride + bcol,
                                bstride);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xc[n][e] += t[n][e];
    }

    const size_t qrow0 = q_rows(it);
    const int q0 = (qt0 + it % per_head) * ZBQ;
    const float* dl = dls + (it & 1) * ZBQ;
    // the tile's S^T or dP^T: the warp's half, then the pair's two halves
    // added in the same order by both warps: word (n, e) of a lane at
    // xsh[((pair * 2 + half) * NQ * 4 + n * 4 + e) * 32 + lane]
    float x[NQ][4];  // S^T or dP^T, then e^T or dS^T
    float* mine = xsh + (pair * 2 + half) * NQ * 4 * 32 + lane;
    const float* h0 = xsh + pair * 2 * NQ * 4 * 32 + lane;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32] = xc[n][e];
    pair_sync(1 + pair);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[n][e] = h0[(n * 4 + e) * 32] + h0[(NQ * 4 + n * 4 + e) * 32];
    // e^T in the C layout: entry (n, 2h + xx) is key keys[h], query q0 + 8n
    // + 2tq + xx; a tile whose every pair is visible skips the masks.  K3b's
    // bias comes from its staged tile (this thread's keys, row `col` at
    // bt[col * ZBS + 8 h]), added to the logit in f32, never split.  The
    // first-half dV warps stage e^T, where the dK warps of the same keys
    // (the same lanes) read it
    const bool whole = keys_whole && q0 + ZBQ <= p.seq_q &&
                       (!p.causal || k0 + ZBK - 1 <= q0 + diff);
    auto keep_at = [&](int h, int qr) {
      bool keep = whole;
      if (!whole) {
        keep = key_ok[h] && qr < p.seq_q;
        if (p.causal) keep = keep && keys[h] <= qr + diff;
      }
      return keep;
    };
    const bool has_bias = !DQ && p.bias != nullptr;
    const float* bt = bss + (it & 1) * ZBQ * ZBS + kg * 16 + g;
    if (forms_dv) {
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int xx = 0; xx < 2; ++xx) {
          const int col = n * 8 + 2 * tq + xx;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float lg = x[n][2 * h + xx] * p.c;
            if (has_bias) lg += bt[col * ZBS + 8 * h] * LOG2E;
            const float e = keep_at(h, q0 + col) ? exp2f(lg) : 0.f;
            x[n][2 * h + xx] = e;
            if (half == 0) es[col * ZDSS + kg * 16 + g + 8 * h] = e;
          }
        }
    }
    __syncthreads();  // e^T is staged
    // the products' column tiles, each word read by two warps, are split
    // as they are read (no room for their lo)
    if (forms_dv) {  // dV[:, the warp's columns] += e^T.dO'[:, those]
      add_product_tf32x3<ZBQ, XCOL / 2, ZRF>(
          acc, x, reinterpret_cast<const float*>(doct) + half * hcols, lane,
          hcols / 8);
    } else {  // dS^T = e^T (dP^T - delta') (K2: staged); dK += dS^T.Q likewise
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int xx = 0; xx < 2; ++xx) {
          const int col = n * 8 + 2 * tq + xx;
          const float dlt = dl[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int at = col * ZDSS + kg * 16 + g + 8 * h;
            const float ds =
                keep_at(h, q0 + col) ? es[at] * (x[n][2 * h + xx] - dlt) : 0.f;
            x[n][2 * h + xx] = ds;
            if (DQ && half == 0) dss[at] = ds;
          }
        }
      add_product_tf32x3<ZBQ, XCOL / 2, ZRF>(
          acc, x, reinterpret_cast<const float*>(qct) + half * hcols, lane,
          hcols / 8);
    }
    // K2: dQ rows of this tile += dS.K[:, cols] over the block's ZBK keys:
    // warp w takes query group w % 2 and columns [(w / 2) ncols / 4, ...).
    // A lane's float2 reads of dS rows g and g + 8 at keys 8kk + 2tq are
    // dS's C fragment of that k8 step, fed to add_product_tf32x3 as an A
    // fragment; K's column tile, each word read by two warps, is split as
    // it is read
    if constexpr (DQ) {
      __syncthreads();  // dS is staged
      const int qg = warp & 1, pcols = ncols / 4, pc0 = (warp >> 1) * pcols;
      float dq[NDQ][4];
#pragma unroll
      for (int n = 0; n < NDQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ZBK / 8; ++kk) {
        const float* row = dss + (qg * 16 + g) * ZDSS + kk * 8 + 2 * tq;
        const float2 r0 = *reinterpret_cast<const float2*>(row);
        const float2 r8 = *reinterpret_cast<const float2*>(row + 8 * ZDSS);
        const float cf[1][4] = {{r0.x, r0.y, r8.x, r8.y}};
        add_product_tf32x3<8, NDQ * 8, ZRF>(dq, cf, kcf + kk * 8 * ZRF + pc0,
                                            lane, pcols / 8);
      }
      float* dqb = p.dq_acc + qrow0 * d + c0 + pc0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + qg * 16 + g + 8 * h;
        if (row >= p.seq_q) continue;
#pragma unroll
        for (int n = 0; n < NDQ; ++n) {
          if (n * 8 >= pcols) break;
          atomicAdd(reinterpret_cast<float2*>(dqb + size_t(row) * d + n * 8 +
                                              2 * tq),
                    make_float2(dq[n][2 * h], dq[n][2 * h + 1]));
        }
      }
    }
    if ((it + 1) % CHAIN == 0 && it + 1 < total) close_chain();
  }
  cp_async_wait<0>();
  close_chain();  // the last chain; with no tile at all the block's zeros
}

// ---------------------------------------------------------------------------
// Wide route's dQ / dB kernel on the tensor cores (bf16): K3a, d a multiple
// of WCOL past 256.  Grid (query tiles, H, B x column blocks of YCOL),
// query tiles heaviest first; YNT threads: warp w owns queries q0 + 16 (w %
// 4) .. and half of the block's dQ columns (w / 4); warps 0-3 form S and
// e, warps 4-7 dP' and dS.

constexpr int YCOL = 256;  // dQ columns of a block: each of a query group's
                           // two warps holds 16 x 128 f32, 64 registers
constexpr int YNT = 256;   // threads: 8 warps
constexpr int YBQ = 64;    // queries of a block
constexpr int YBK = 64;    // keys a tile
constexpr int YBS = YBK + 8;  // bias row stride, floats (as DqLayout's)
constexpr size_t YSTAGE = size_t(2 * YBQ + 2 * YBK) * XCS;  // Q, dO', K, V
struct YLayout {
  // two chunk stages; K's column tile; e, then dS, as C fragments; then
  // the bias tile (YBQ queries x YBK keys, f32).  The column tile and the
  // bias tile come with a key tile's last chunk and are read only at it,
  // so one buffer of each serves: the next tile's arrive two steps later
  // at the earliest (a row has at least 3 chunks past d 256)
  static constexpr size_t CHUNKS = 0;
  static constexpr size_t KCOL = CHUNKS + 2 * YSTAGE;
  static constexpr size_t ES = KCOL + size_t(YBK) * XVS;
  static constexpr size_t BASE = ES + sizeof(float) * YBQ * YBK;
  static constexpr size_t BIAS = sizeof(float) * YBQ * YBS;
};
static_assert(YLayout::BASE + YLayout::BIAS <= 232448,
              "the wide dQ kernel's shared memory fits a block");

__global__ void __launch_bounds__(YNT, 1) dq_wide_mma_kernel(Params p, int d) {
  using T = __nv_bfloat16;
  using L = YLayout;
  constexpr int NK = YBK / 8;        // n8 tiles of a warp's (16 x YBK) tile
  constexpr int NA = YCOL / 2 / 8;   // n8 tiles of a warp's dQ columns
  extern __shared__ __align__(16) unsigned char msmem[];
  unsigned char* kcol = msmem + L::KCOL;                // K[keys, cols]
  float* es = reinterpret_cast<float*>(msmem + L::ES);  // e, then dS
  float* bss = reinterpret_cast<float*>(msmem + L::BASE);  // the bias tile

  const int ncb = (d + YCOL - 1) / YCOL;
  const int bi = blockIdx.z / ncb, cb = blockIdx.z % ncb, c0 = cb * YCOL;
  const int hcols = min(YCOL, d - c0) / 2;  // a warp's dQ columns
  const int hi = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * YBQ;  // heaviest first
  const int kvhi = hi / (p.H / p.KVH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int qg = warp & 3;             // the warp's 16 queries
  const bool forms_s = warp < 4;       // warp-uniform roles
  const int part = warp >> 2;          // its half of the dQ columns
  const int diff = p.seq_k - p.seq_q;
  const int RB = 2 * d;                // bytes of a row
  const int nch = RB / XCB;            // chunks of it
  const size_t qrow0 = (size_t(bi) * p.H + hi) * p.seq_q;
  const size_t kvrow0 = (size_t(bi) * p.KVH + kvhi) * p.seq_k;
  auto bytes = [&](const void* t, size_t row0) {
    return reinterpret_cast<const unsigned char*>(static_cast<const T*>(t) +
                                                  row0 * d);
  };
  const unsigned char* qb = bytes(p.q, qrow0);
  const unsigned char* dob = bytes(p.dO, qrow0);
  const unsigned char* kb = bytes(p.k, kvrow0);
  const unsigned char* vb = bytes(p.v, kvrow0);
  const uint8_t* mb = p.mask ? p.mask + size_t(bi) * p.seq_k : nullptr;
  const size_t bslice = size_t(p.bias_batch_dim ? bi : hi) * p.seq_q * p.seq_k;
  const float* bb = p.bias ? p.bias + bslice : nullptr;
  float* db = p.db && cb == 0 ? p.db + bslice : nullptr;  // counted once

  // keys this block can see: all, or (causal) up to its last row's diagonal
  const int last_row = min(q0 + YBQ, p.seq_q) - 1;
  const int kend = p.causal ? max(0, min(p.seq_k, last_row + diff + 1)) : p.seq_k;
  const int nk = (kend + YBK - 1) / YBK;
  const int steps = nk * nch;  // (key tile, chunk), chunks fastest

  const bool bias16 =
      p.seq_k % 4 == 0 && reinterpret_cast<uintptr_t>(p.bias) % 16 == 0;
  // step st's Q, dO', K and V chunks into stage st & 1; a key tile's last
  // step also brings K's column tile and the bias tile
  auto issue = [&](int st) {
    if (st < steps) {
      const int k0 = (st / nch) * YBK, ch = st % nch, off = ch * XCB;
      unsigned char* stg = msmem + L::CHUNKS + (st & 1) * YSTAGE;
      load_row_part<YNT>(stg, qb, q0, YBQ, p.seq_q, RB, off, XCB, XCS);
      load_row_part<YNT>(stg + YBQ * XCS, dob, q0, YBQ, p.seq_q, RB, off, XCB,
                         XCS);
      load_row_part<YNT>(stg + 2 * YBQ * XCS, kb, k0, YBK, p.seq_k, RB, off,
                         XCB, XCS);
      load_row_part<YNT>(stg + (2 * YBQ + YBK) * XCS, vb, k0, YBK, p.seq_k, RB,
                         off, XCB, XCS);
      if (ch == nch - 1) {
        load_row_part<YNT>(kcol, kb, k0, YBK, p.seq_k, RB, 2 * c0, 4 * hcols,
                           XVS);
        if (bb != nullptr)
          load_bias_tile<YNT>(bss, bb + size_t(q0) * p.seq_k + k0, YBQ, YBK,
                              p.seq_q - q0, p.seq_k - k0, p.seq_k, YBS, bias16);
      }
    }
    cp_async_commit();
  };
  issue(0);

  // this thread's query rows: C rows g and g + 8 of the warp's 16
  const int rows[2] = {q0 + qg * 16 + g, q0 + qg * 16 + g + 8};
  float dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    dlt[h] = rows[h] < p.seq_q ? p.delta[qrow0 + rows[h]] : 0.f;
  // dS goes to dB as float2 adds where a row's entries pair up 8-byte
  // aligned (even seq_k: the tile columns 2tq are even)
  const bool db2 = p.seq_k % 2 == 0;

  float acc[NA][4];  // dQ[rows, c0 + part * hcols ..]
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float sc[NK][4];   // S (warps 0-3) or dP' (warps 4-7), summed over d
  float* ef = es + qg * NK * 4 * 32 + lane;  // this lane's e / dS entries

  for (int st = 0; st < steps; ++st) {
    issue(st + 1);
    cp_async_wait<1>();
    __syncthreads();  // step st's chunks (and its tile's column tiles) landed
    const int ch = st % nch, k0 = (st / nch) * YBK;
    const unsigned char* stg = msmem + L::CHUNKS + (st & 1) * YSTAGE;
    if (ch == 0) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    }
    // S += Q.K^T (warps 0-3) or dP' += dO'.V^T (warps 4-7) over the chunk:
    // an x4 ldmatrix of K / V gives the B fragments of 2 n8 tiles
    {
      const unsigned char* at = stg + (forms_s ? 0 : YBQ * XCS);
      const unsigned char* bt = stg + (2 * YBQ + (forms_s ? 0 : YBK)) * XCS;
#pragma unroll
      for (int kk = 0; kk < XCB / 32; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, at + (qg * 16 + (lane & 15)) * XCS + kk * 32 +
                           (lane >> 4) * 16);
#pragma unroll
        for (int j = 0; j < NK / 2; ++j) {
          uint32_t b[4];
          ldmatrix_x4(b, bt + (j * 16 + (lane & 7) + (lane >> 4) * 8) * XCS +
                             kk * 32 + ((lane >> 3) & 1) * 16);
          mma_bf16(sc[2 * j], a, b[0], b[1]);
          mma_bf16(sc[2 * j + 1], a, b[2], b[3]);
        }
      }
    }
    if (ch != nch - 1) {
      __syncthreads();  // the next step's loads may overwrite this stage
      continue;
    }

    // e in the C layout: entry (n, 2h + x) is query rows[h], key k0 + 8n +
    // 2tq + x.  A tile whose every pair is visible (no key mask, inside
    // both lengths and the causal diagonal) skips the masks; the bias
    // comes from its staged tile
    if (forms_s) {
      const bool whole = mb == nullptr && k0 + YBK <= p.seq_k &&
                         q0 + YBQ <= p.seq_q &&
                         (!p.causal || k0 + YBK - 1 <= q0 + diff);
      const float* bt = bss + (qg * 16 + g) * YBS + 2 * tq;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2 bv = make_float2(0.f, 0.f);
          if (bb != nullptr)
            bv = *reinterpret_cast<const float2*>(bt + 8 * h * YBS + n * 8);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float lg = sc[n][2 * h + x] * p.c + (x ? bv.y : bv.x) * LOG2E;
            bool keep = true;
            if (!whole) {
              const int c = k0 + n * 8 + 2 * tq + x;
              keep = rows[h] < p.seq_q && c < p.seq_k;
              if (p.causal) keep = keep && c <= rows[h] + diff;
              if (mb != nullptr) keep = keep && mb[min(c, p.seq_k - 1)] != 0;
            }
            const float e = keep ? exp2f(lg) : 0.f;
            sc[n][2 * h + x] = e;
            ef[(n * 4 + 2 * h + x) * 32] = e;
          }
        }
    }
    __syncthreads();  // e is staged for the dP' warps
    if (!forms_s) {
      // dS = e (dP' - delta'), e from the S warp of these queries, written
      // back over it; each (row, key pair) adds its two dS to dB at once,
      // before any rounding
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float ds[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            float* at = ef + (n * 4 + 2 * h + x) * 32;
            ds[x] = *at * (sc[n][2 * h + x] - dlt[h]);
            sc[n][2 * h + x] = ds[x];
            *at = ds[x];
          }
          const int col = k0 + n * 8 + 2 * tq;
          if (db != nullptr && (ds[0] != 0.f || ds[1] != 0.f)) {
            float* at = db + size_t(rows[h]) * p.seq_k + col;
            if (db2 && col + 1 < p.seq_k) {
              atomicAdd(reinterpret_cast<float2*>(at), make_float2(ds[0], ds[1]));
            } else {
              if (ds[0] != 0.f) atomicAdd(at, ds[0]);
              if (ds[1] != 0.f) atomicAdd(at + 1, ds[1]);
            }
          }
        }
    }
    __syncthreads();  // dS is staged for the S warps
    if (forms_s) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = ef[(n * 4 + e) * 32];
    }
    // dQ[:, the warp's columns] += dS.K[:, those columns]: n8 tiles 2j, 2j
    // + 1 of dS are the A fragments (hi and lo) of k16 step j
    add_product_cols<YBK, XVS>(acc, sc, kcol + 2 * part * hcols, lane,
                               hcols / 16);
    __syncthreads();  // the next steps' loads may overwrite these buffers
  }
  cp_async_wait<0>();

  T* dqb = static_cast<T*>(p.dq) + qrow0 * d + c0 + part * hcols;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= p.seq_q) continue;
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      if (n * 8 >= hcols) break;
      *reinterpret_cast<uint32_t*>(dqb + size_t(rows[h]) * d + n * 8 + 2 * tq) =
          pack_bf16(acc[n][2 * h] * p.scale, acc[n][2 * h + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Wide route's dQ / dB kernel on the tensor cores in float32 (3xTF32): K3a,
// d a multiple of WCOL past 256.  Grid (query tiles of UBQ, H, B x column
// blocks of XCOL), query tiles heaviest first; UNT threads: warp w owns
// queries q0 + 16 (w % 4) .. and half w / 4 of the block's dQ columns;
// warps 0-3 form S and e, warps 4-7 dP' and dS, each over whole chunks.

constexpr int UNT = 256;      // threads: 8 warps
constexpr int UBQ = 64;       // queries of a block
constexpr int UBK = 32;       // keys a tile
constexpr int UBS = UBK + 8;  // bias row stride, floats (as DqLayout's)
struct ULayout {
  // the chunk stages (Q's, dO''s, K's and V's rows); K's column tile (the
  // tile's keys x the block's columns); e, then dS, as C fragments; then
  // the bias tile (UBQ queries x UBK keys, f32).  A key tile's own chunks
  // (the block's columns) come last and K's land in the column tile, the
  // product's operand, not in the ring; the bias tile comes with the first
  // of them.  Both are read only at the tile's end, so one buffer of each
  // serves: the next tile's own chunks are issued at least ZSTAGES - 1
  // steps into it (d being at least 384), after its first barrier
  static constexpr size_t STAGE = size_t(2 * UBQ + 2 * UBK) * ZCS;
  static constexpr size_t KCOL = ZSTAGES * STAGE;
  static constexpr size_t ES = KCOL + size_t(UBK) * ZRF * 4;
  static constexpr size_t BASE = ES + sizeof(float) * UBQ * UBK;
  static constexpr size_t BIAS = sizeof(float) * UBQ * UBS;
};
static_assert(ULayout::BASE + ULayout::BIAS <= 232448,
              "the wide f32 K3a's shared memory");

__global__ void __launch_bounds__(UNT, 1) dq_wide_tf32_kernel(Params p,
                                                              int d) {
  using L = ULayout;
  constexpr int NK = UBK / 8;         // n8 tiles of a warp's (16 x UBK) tile
  constexpr int NA = XCOL / 2 / 8;    // n8 tiles of its dQ columns
  constexpr int KSTEPS = ZKC / 8;     // k steps of a chunk
  extern __shared__ __align__(16) unsigned char msmem[];
  unsigned char* kct = msmem + L::KCOL;                    // K[keys, cols]
  float* es = reinterpret_cast<float*>(msmem + L::ES);     // e, then dS
  float* bss = reinterpret_cast<float*>(msmem + L::BASE);  // the bias tile

  const int ncb = (d + XCOL - 1) / XCOL;
  const int bi = blockIdx.z / ncb, cb = blockIdx.z % ncb, c0 = cb * XCOL;
  const int ncols = min(XCOL, d - c0);  // 256, or 128 (d an odd multiple)
  const int hcols = ncols / 2;          // a warp's dQ columns
  const int hi = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * UBQ;  // heaviest first
  const int kvhi = hi / (p.H / p.KVH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int qg = warp & 3;             // the warp's 16 queries
  const bool forms_s = warp < 4;       // warp-uniform roles
  const int part = warp >> 2;          // its half of the dQ columns
  const int diff = p.seq_k - p.seq_q;
  const int RB = 4 * d;                // bytes of a row
  const int nch = d / ZKC;             // chunks of it
  // a tile's chunks run from the one past the block's columns round to
  // them, so the block's own chunks come last (dkdv_wide_tf32_kernel's
  // order)
  const int nown = ncols / ZKC, ce = c0 / ZKC + nown;
  const size_t qrow0 = (size_t(bi) * p.H + hi) * p.seq_q;
  const size_t kvrow0 = (size_t(bi) * p.KVH + kvhi) * p.seq_k;
  auto bytes = [&](const void* t, size_t row0) {
    return reinterpret_cast<const unsigned char*>(static_cast<const float*>(t) +
                                                  row0 * d);
  };
  const unsigned char* qb = bytes(p.q, qrow0);
  const unsigned char* dob = bytes(p.dO, qrow0);
  const unsigned char* kb = bytes(p.k, kvrow0);
  const unsigned char* vb = bytes(p.v, kvrow0);
  const uint8_t* mb = p.mask ? p.mask + size_t(bi) * p.seq_k : nullptr;
  const size_t bslice = size_t(p.bias_batch_dim ? bi : hi) * p.seq_q * p.seq_k;
  const float* bb = p.bias ? p.bias + bslice : nullptr;
  float* db = p.db && cb == 0 ? p.db + bslice : nullptr;  // counted once

  // keys this block can see: all, or (causal) up to its last row's diagonal
  const int last_row = min(q0 + UBQ, p.seq_q) - 1;
  const int kend = p.causal ? max(0, min(p.seq_k, last_row + diff + 1)) : p.seq_k;
  const int nk = (kend + UBK - 1) / UBK;
  const int steps = nk * nch;  // (key tile, chunk), chunks fastest

  const bool bias16 =
      p.seq_k % 4 == 0 && reinterpret_cast<uintptr_t>(p.bias) % 16 == 0;
  // step st's Q, dO', K and V chunks into stage st % ZSTAGES, K's own
  // chunks into the column tile; the first own step also brings the bias
  // tile
  auto issue = [&](int st) {
    if (st < steps) {
      const int kt = st / nch, i = st - kt * nch, k0 = kt * UBK;
      const int off = (ce + i) % nch * ZKC;
      const bool own = i >= nch - nown;
      unsigned char* stg = msmem + (st % ZSTAGES) * L::STAGE;
      load_row_part<UNT>(stg, qb, q0, UBQ, p.seq_q, RB, 4 * off, 4 * ZKC, ZCS);
      load_row_part<UNT>(stg + UBQ * ZCS, dob, q0, UBQ, p.seq_q, RB, 4 * off,
                         4 * ZKC, ZCS);
      load_row_part<UNT>(own ? kct + (off - c0) * 4 : stg + 2 * UBQ * ZCS, kb,
                         k0, UBK, p.seq_k, RB, 4 * off, 4 * ZKC,
                         own ? ZRF * 4 : ZCS);
      load_row_part<UNT>(stg + (2 * UBQ + UBK) * ZCS, vb, k0, UBK, p.seq_k, RB,
                         4 * off, 4 * ZKC, ZCS);
      if (i == nch - nown && bb != nullptr)
        load_bias_tile<UNT>(bss, bb + size_t(q0) * p.seq_k + k0, UBQ, UBK,
                            p.seq_q - q0, p.seq_k - k0, p.seq_k, UBS, bias16);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < ZSTAGES - 1; ++st) issue(st);

  // this thread's query rows: C rows g and g + 8 of the warp's 16
  const int rows[2] = {q0 + qg * 16 + g, q0 + qg * 16 + g + 8};
  float dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    dlt[h] = rows[h] < p.seq_q ? p.delta[qrow0 + rows[h]] : 0.f;
  // dS goes to dB as float2 adds where a row's entries pair up 8-byte
  // aligned (even seq_k: the tile columns 2tq are even)
  const bool db2 = p.seq_k % 2 == 0;
  // the warp's A rows (its 16 queries of Q or dO') in a chunk stage; its B
  // rows (K or V: x4 ldmatrix of 2 n8 tiles) from their first
  const int arow = (forms_s ? 0 : UBQ * ZCS) + (qg * 16 + (lane & 15)) * ZCS +
                   (lane >> 4) * 16;
  const int brow = (lane & 7) + (lane >> 4) * 8;
  const int bcol = ((lane >> 3) & 1) * 16;
  float* ef = es + qg * NK * 4 * 32 + lane;  // this lane's e / dS entries

  // dQ sums every visible key, each mma rounding its sum toward zero: every
  // CHAIN tiles (256 keys) the chain is closed into the thread's own dQ
  // words in global memory (scaled), added to nearest, as dq_tf32_kernel
  // does above d 128, and the accumulators restart from 0
  constexpr int CHAIN = 256 / UBK;
  float acc[NA][4];  // dQ[rows, c0 + part * hcols ..]
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float* const dqh = static_cast<float*>(p.dq) + qrow0 * d + c0 + part * hcols;
  bool stored = false;
  auto close_chain = [&]() {
    close_chain_rows(acc, dqh, rows, p.seq_q, d, hcols / 8, p.scale, stored,
                     tq);
    stored = true;
  };

  for (int kt = 0; kt < nk; ++kt) {
    // S (warps 0-3) or dP' (warps 4-7) over d, each chunk's in four
    // accumulators (scores_tf32x3) closed into xc, added to nearest, as
    // dkdv_wide_tf32_kernel's S^T and dP^T
    float xc[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xc[n][e] = 0.f;
    for (int i = 0; i < nch; ++i) {
      const int st = kt * nch + i;
      cp_async_wait<ZSTAGES - 2>();
      __syncthreads();  // step st's chunks have landed, and step st - 1's
                        // readers are done
      issue(st + ZSTAGES - 1);  // into step st - 1's stage
      // the warp's own Q or dO' rows split at each fragment load, K's and
      // V's (four warps read each) too; the own chunks' K rows from the
      // column tile
      const unsigned char* stg = msmem + (st % ZSTAGES) * L::STAGE;
      const bool own = forms_s && i >= nch - nown;
      const unsigned char* bsrc =
          own ? kct + ((ce + i) % nch * ZKC - c0) * 4
              : stg + (2 * UBQ + (forms_s ? 0 : UBK)) * ZCS;
      const int bstride = own ? ZRF * 4 : ZCS;
      float t[NK][4];
      scores_tf32x3<NK, KSTEPS>(t, stg + arow, bsrc + brow * bstride + bcol,
                                bstride);
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xc[n][e] += t[n][e];
    }

    // e and dS in the C layout: entry (n, 2h + x) is query rows[h], key k0
    // + 8n + 2tq + x.  A tile whose every pair is visible (no key mask,
    // inside both lengths and the causal diagonal) skips the masks; hidden
    // entries are selected to exact 0
    const int k0 = kt * UBK;
    const bool whole = mb == nullptr && k0 + UBK <= p.seq_k &&
                       q0 + UBQ <= p.seq_q &&
                       (!p.causal || k0 + UBK - 1 <= q0 + diff);
    auto keep_at = [&](int h, int c) {
      if (whole) return true;
      bool keep = rows[h] < p.seq_q && c < p.seq_k;
      if (p.causal) keep = keep && c <= rows[h] + diff;
      if (mb != nullptr) keep = keep && mb[min(c, p.seq_k - 1)] != 0;
      return keep;
    };
    if (forms_s) {
      // e = exp2(c s + bias log2e), the bias from its staged tile (this
      // thread's row g and column 2tq), added in f32, never split
      const float* bt = bss + (qg * 16 + g) * UBS + 2 * tq;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2 bv = make_float2(0.f, 0.f);
          if (bb != nullptr)
            bv = *reinterpret_cast<const float2*>(bt + 8 * h * UBS + n * 8);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float lg = xc[n][2 * h + x] * p.c + (x ? bv.y : bv.x) * LOG2E;
            ef[(n * 4 + 2 * h + x) * 32] =
                keep_at(h, k0 + n * 8 + 2 * tq + x) ? exp2f(lg) : 0.f;
          }
        }
    }
    pair_sync(1 + qg);  // e is staged for the dP' warp of these queries
    if (!forms_s) {
      // dS = e (dP' - delta'), written back over e; each (row, key pair)
      // adds its two dS to dB at once, before any rounding (column block 0
      // alone, else dB would be counted once a column block)
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = k0 + n * 8 + 2 * tq;
          float ds[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            float* at = ef + (n * 4 + 2 * h + x) * 32;
            ds[x] = keep_at(h, col + x) ? *at * (xc[n][2 * h + x] - dlt[h])
                                        : 0.f;
            xc[n][2 * h + x] = ds[x];
            *at = ds[x];
          }
          if (db != nullptr && (ds[0] != 0.f || ds[1] != 0.f)) {
            float* at = db + size_t(rows[h]) * p.seq_k + col;
            if (db2 && col + 1 < p.seq_k) {
              atomicAdd(reinterpret_cast<float2*>(at), make_float2(ds[0], ds[1]));
            } else {
              if (ds[0] != 0.f) atomicAdd(at, ds[0]);
              if (ds[1] != 0.f) atomicAdd(at + 1, ds[1]);
            }
          }
        }
    }
    pair_sync(1 + qg);  // dS is staged for the S warp
    if (forms_s) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xc[n][e] = ef[(n * 4 + e) * 32];
    }
    // dQ[:, the warp's columns] += dS.K[:, those columns], dS in f32 (split
    // hi / lo in registers): the C fragment of dS holds keys 2q and 2q + 1,
    // the tf32 A fragment's k indices q and q + 4 when K's rows are read in
    // that order (add_product_tf32x3); K's column tile, each word read by
    // four warps, is split as it is read
    add_product_tf32x3<UBK, XCOL / 2, ZRF>(
        acc, xc, reinterpret_cast<const float*>(kct) + part * hcols, lane,
        hcols / 8);
    if ((kt + 1) % CHAIN == 0 && kt + 1 < nk) close_chain();
  }
  cp_async_wait<0>();
  close_chain();  // the last chain, or (no key visible) zeros
}

enum Which { ONEPASS = 0, DQ = 1, DKDV = 2 };

template <typename Kernel, typename... Extra>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t s, const Params& p, Extra... extra) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(p, extra...);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(Which which, const Params& p, int B, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // 16-byte copies: every row is a 16-byte multiple, so aligned bases do
    for (const void* t : {p.q, p.k, p.v, p.dO})
      if (reinterpret_cast<uintptr_t>(t) % 16 != 0) return cudaErrorMisalignedAddress;
    if (which == DQ) {
      using L = DqLayout<D>;
      return launch(dq_mma_kernel<T, D>,
                    dim3((p.seq_q + DQ_BQ - 1) / DQ_BQ, p.H, B), DQ_NT,
                    L::BASE + (p.bias ? L::BIAS : 0), s, p);
    }
    // key tiles slowest, so the causal blocks with the most work go first
    const dim3 grid(p.KVH, B, (p.seq_k + MBK - 1) / MBK);
    using L2 = MmaLayout<D, true>;
    using L3 = MmaLayout<D, false>;
    return which == ONEPASS
               ? launch(dkdv_mma_kernel<T, D, true>, grid, L2::NT,
                        L2::BASE + L2::DST, s, p)
               : launch(dkdv_mma_kernel<T, D, false>, grid, L3::NT,
                        L3::BASE + (p.bias ? L3::BIAS : 0), s, p);
  } else {  // float32: K2, K3a and K3b on the tensor cores (3xTF32)
    for (const void* t : {p.q, p.k, p.v, p.dO})
      if (reinterpret_cast<uintptr_t>(t) % 16 != 0)
        return cudaErrorMisalignedAddress;
    if (which == ONEPASS) {
      using L2 = Tf32Layout<D, true>;
      static_assert(L2::BASE <= 232448, "K2 f32 shared memory");
      // key tiles slowest, so the causal blocks with the most work go first
      return launch(dkdv_tf32_kernel<D, true>,
                    dim3(p.KVH, B, (p.seq_k + L2::BK - 1) / L2::BK), L2::NT,
                    L2::BASE, s, p);
    }
    if (which == DQ) {
      using L = DqTf32Layout<D>;
      static_assert(L::BASE + L::BIAS <= 232448, "K3a f32 shared memory");
      return launch(dq_tf32_kernel<D>,
                    dim3((p.seq_q + DQ_BQ - 1) / DQ_BQ, p.H, B), DQ_NT,
                    L::BASE + (p.bias ? L::BIAS : 0), s, p);
    }
    using L3 = Tf32Layout<D, false>;
    static_assert(L3::BASE + L3::BIAS <= 232448, "K3b f32 shared memory");
    return launch(dkdv_tf32_kernel<D, false>,
                  dim3(p.KVH, B, (p.seq_k + L3::BK - 1) / L3::BK), L3::NT,
                  L3::BASE + (p.bias ? L3::BIAS : 0), s, p);
  }
}

template <typename T>
cudaError_t run_wide(Which which, const Params& p, int B, int d,
                     cudaStream_t s) {
  if (d % WCOL != 0) return cudaErrorInvalidValue;
  // 16-byte copies: every row is a 16-byte multiple, so aligned bases do
  for (const void* t : {p.q, p.k, p.v, p.dO})
    if (reinterpret_cast<uintptr_t>(t) % 16 != 0) return cudaErrorMisalignedAddress;
  const int ncb = (d + XCOL - 1) / XCOL;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (which == DQ)
      return launch(dq_wide_mma_kernel,
                    dim3((p.seq_q + YBQ - 1) / YBQ, p.H, B * ncb), YNT,
                    YLayout::BASE + (p.bias ? YLayout::BIAS : 0), s, p, d);
    // key tiles slowest, so the causal blocks with the most work go first
    const dim3 grid(p.KVH, B * ncb, (p.seq_k + MBK - 1) / MBK);
    return which == ONEPASS
               ? launch(dkdv_wide_mma_kernel<true>, grid, XNT, XLayout::K2, s,
                        p, d)
               : launch(dkdv_wide_mma_kernel<false>, grid, XNT,
                        XLayout::K3 + (p.bias ? XLayout::BIAS : 0), s, p, d);
  } else {  // float32: K2, K3a and K3b on the tensor cores (3xTF32)
    if (which == DQ)
      return launch(dq_wide_tf32_kernel,
                    dim3((p.seq_q + UBQ - 1) / UBQ, p.H, B * ncb), UNT,
                    ULayout::BASE + (p.bias ? ULayout::BIAS : 0), s, p, d);
    // key tiles slowest, as above
    const dim3 grid(p.KVH, B * ncb, (p.seq_k + ZBK - 1) / ZBK);
    using L3 = ZLayout<false>;
    return which == ONEPASS
               ? launch(dkdv_wide_tf32_kernel<true>, grid, ZNT,
                        ZLayout<true>::BASE, s, p, d)
               : launch(dkdv_wide_tf32_kernel<false>, grid, ZNT,
                        L3::BASE + (p.bias ? L3::BIAS : 0), s, p, d);
  }
}

template <typename T>
cudaError_t run_d(int d, Which which, const Params& p, int B, cudaStream_t s) {
  if (d > 256) return run_wide<T>(which, p, B, d, s);
  switch (d) {
    case 16: return run<T, 16>(which, p, B, s);
    case 32: return run<T, 32>(which, p, B, s);
    case 64: return run<T, 64>(which, p, B, s);
    case 96: return run<T, 96>(which, p, B, s);
    case 128: return run<T, 128>(which, p, B, s);
    case 192: return run<T, 192>(which, p, B, s);
    case 256: return run<T, 256>(which, p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(Which which, Params p, int dtype, int B, int d, void* stream) {
  if (B <= 0 || p.H <= 0 || p.KVH <= 0 || p.H % p.KVH != 0 || p.seq_q <= 0 ||
      p.seq_k <= 0)
    return int(cudaErrorInvalidValue);
  p.c = float(double(p.scale) * 1.4426950408889634);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(run_d<float>(d, which, p, B, s));
  if (dtype == 1) return int(run_d<__nv_bfloat16>(d, which, p, B, s));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the dq/dk/dv outputs
// share it).  bfloat16 runs on the tensor cores; float32 K2, K3a and K3b
// on them as 3xTF32, at every width.
// All tensors contiguous, shapes as in Params; mask uint8 or null, bias
// f32 or null.  Each returns the cudaGetLastError() after its launch (0 =
// success).

// K2: dk, dv in the input dtype (dk scaled); dq_acc (B, H, seq_q, d) f32,
// zeroed by the caller, receives the unscaled sum of dS . k.
extern "C" int fcsa_bwd_onepass(const void* q, const void* k, const void* v,
                                const void* dO, const void* delta,
                                const void* mask, void* dq_acc, void* dk,
                                void* dv, int dtype, int B, int H, int KVH,
                                int seq_q, int seq_k, int d, int causal,
                                float scale, void* stream) {
  Params p{q, k, v, dO, static_cast<const float*>(delta),
           static_cast<const uint8_t*>(mask), nullptr, nullptr,
           static_cast<float*>(dq_acc), dk, dv, nullptr,
           H, KVH, seq_q, seq_k, causal, 0, scale, 0.f};
  return dispatch(ONEPASS, p, dtype, B, d, stream);
}

// K3a: dq in the input dtype (scaled); db (B|H, seq_q, seq_k) f32, zeroed
// by the caller, receives dB when a bias is given (null otherwise).
extern "C" int fcsa_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dO, const void* delta, const void* mask,
                           const void* bias, void* dq, void* db, int dtype,
                           int B, int H, int KVH, int seq_q, int seq_k, int d,
                           int causal, int bias_batch_dim, float scale,
                           void* stream) {
  Params p{q, k, v, dO, static_cast<const float*>(delta),
           static_cast<const uint8_t*>(mask), static_cast<const float*>(bias),
           dq, nullptr, nullptr, nullptr, static_cast<float*>(db),
           H, KVH, seq_q, seq_k, causal, bias_batch_dim, scale, 0.f};
  return dispatch(DQ, p, dtype, B, d, stream);
}

// K3b: dk (scaled), dv in the input dtype.
extern "C" int fcsa_bwd_dkdv(const void* q, const void* k, const void* v,
                             const void* dO, const void* delta,
                             const void* mask, const void* bias, void* dk,
                             void* dv, int dtype, int B, int H, int KVH,
                             int seq_q, int seq_k, int d, int causal,
                             int bias_batch_dim, float scale, void* stream) {
  Params p{q, k, v, dO, static_cast<const float*>(delta),
           static_cast<const uint8_t*>(mask), static_cast<const float*>(bias),
           nullptr, nullptr, dk, dv, nullptr,
           H, KVH, seq_q, seq_k, causal, bias_batch_dim, scale, 0.f};
  return dispatch(DKDV, p, dtype, B, d, stream);
}
