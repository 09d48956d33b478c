"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. build the kernels with nvcc for sm_90a, one nvcc per source, in
     parallel: K1, K3 and K4 phase A (csrc/intersect.cu), K2 scatter-add
     (csrc/scatter.cu), K5 triangle sweep and K6 cluster sweep
     (csrc/triangles.cu); ptxas statistics printed;
  2. K1 against its plain PyTorch version on the card, for the 1024x1024
     zy camera rays and 65,536 random rays (numpy seed 0): hit/miss,
     kind and index equal, t bit-equal;
  3. the main path: load data/zy_scene.json, Renderer(1024x1024,
     max_depth=20, device="cuda"), render(k) for k = 0..3 -- finite,
     non-negative images with a mean in 0.1-0.4, render(0) deterministic,
     and K1 launched by those renders;
  4. at 256x256 depth 20, trace_compacted equals the dense trace, and a
     64x64 depth-1 image on the card equals the port's CPU render;
  5. timings with CUDA events: ms per 1024x1024 depth-20 pass, traced
     segments per second, K1 against its plain version on a 65,536-ray
     tile, beside an empty kernel launched the same way (the floor);
  6. K2 against its plain version run on the CPU, into the 524,288-texel
     zy atlas-gradient table, bit for bit, and two runs on the card
     bit-identical: 1,310,720 seeded rows (~5 % live, heavy duplicates),
     the same rows without duplicates, the real rows of one zy tile's
     tape sweep into the table [gimg | gcol | gmet] (each stage, and the
     three stages in one call) and 288,164 rows all live;
  7. the gradient path: zy at 1024x1024 depth GRAD_DEPTH, params_of ->
     tiled_loss_and_grad in 16 tiles of 65,536 rays under one trace key
     with ids_base (per tile the taped forward and its sweep), one global
     scalar_tangent_pass; loss = image mean.  All five gradient
     leaves finite and nonzero, K1 and K2 launched, the loss equal to the
     mean of the image render_pass draws (the renderer's own entry, rtol
     1e-5), the color gradient against a central difference of that mean
     on the card (eps 1e-2, rtol 1e-2), a second pass at the same key equal in loss and in
     the color, images and metal-albedo gradients (K2's leaves) bit for
     bit, fuzz and IR to rtol 1e-4, and three SGD steps of an L2 fit to a
     target rendered under another key;
  8. timings with CUDA events: ms per 1024x1024 depth-GRAD_DEPTH fwd+bwd
     pass and traced segments per second (counted untimed on the same keys, as
     bench.py counts them; 1024^2 rays per second beside it), split into
     taped forward, sweep and tangent pass; the device's busy share over
     one tile's fwd+bwd; K2 on one zy tile's sweep rows (one call, two
     launches) against its plain version, index_add_ and the deterministic
     index_put_ on the live rows, and the empty kernel;
  9. K3 (the transformed phase A, csrc/intersect.cu) against its plain
     version on the card, for the 800x800 camera rays of data/scene.json
     and 65,536 random rays in its box (numpy seed 0): hit/miss, kind
     and index equal, t bit-equal, winners on the rotated cuboid;
 10. K5 (the triangle sweep, csrc/triangles.cu) against its dense plain
     version (no cull) on the same camera rays, 65,536 rays aimed at the
     bunny and 65,536 secondary rays from the camera rays' mesh hits
     (secondary_rays): hit/miss and index equal, t bit-equal on hits,
     > 1 % of the rays on the mesh; needed pairs and per-warp list
     lengths and sweeps printed;
 11. the second main path: load data/scene.json, Renderer(800x800,
     max_depth=50, device="cuda"), render(k) for k = 0..2 -- finite,
     non-negative images with a mean in 0.55-0.65 (JAX CPU renders give
     0.58-0.61, PERF.md), render(0) deterministic, K3 and K5 launched;
 12. at 128x128 depth 50, compacted equals dense, and a 32x32 depth-1
     image on the card equals the port's CPU render;
 13. timings: ms per 800x800 depth-50 pass, segments per second, K3
     against its plain version on a 65,536-ray tile, K5 on the busiest
     camera-ray tile, the bunny-aimed tile and the secondary tile (CUDA
     events and torch.profiler device time, beside the needed pairs, the
     bound and the share), K5's plain version on the secondary tile, the
     device's busy share over a profiled 128x128 depth-50 pass and K5's
     part of it;
 14. K4 and K6 are among the builds of phase 1 (ptxas counts) and load;
 15. K6 against its plain version (cluster_sweep_plain) on the 512x512
     camera rays of C6 (scenes.bunny_grid: 79,488 triangles, 621
     clusters of 128), 65,536 rays aimed at the grid, 65,536 secondary
     rays from the camera rays' mesh hits (also against the dense plain
     version) and 65,536 rays on 27 bunnies (1,048 clusters, K7's case):
     hit/miss and index equal, t bit-equal on hits; the needed pairs and
     the per-warp list lengths and sweeps; K1 against its plain version on
     C6's own table (its ground rect) for the same camera rays and
     secondary rays, as phase 2;
 16. the C6 path: Renderer(512x512, default depth 20), render(k) for
     k = 0..2 -- finite, non-negative, mean in C6_MEAN, render(0)
     deterministic, K6 launched and K5 not; 32x32 depth-1 card == CPU;
 17. K4 against its plain version on the 384x384 camera rays of the
     motion scene (scenes.motion_blur) at their own shutter times, and
     65,536 random rays at seeded times: kind, index equal, t bit-equal;
 18. the motion path: Renderer(384x384, depth 8), render(k) for
     k = 0..2 -- as phase 16 with MB_MEAN, K4 launched and K1 not;
     128x128 compacted == dense; 32x32 depth-1 card == CPU;
 19. timings: ms per pass and segments/s of both scenes, K6 on the
     busiest C6 camera-ray tile, the C6 secondary tile and the 27-bunny
     tile of phase 15 (K7's case) as in 13, its
     plain version on the secondary tile, K1 on C6's table and the
     secondary tile against its plain version and its bound, K4 against
     its plain version (CUDA events and torch.profiler), the device's
     busy share over
     profiled 128x128 passes of both and K6's part of C6's;
 20. K1, K3 and K4 against their plain version on tables past the 48 KB
     a block gets without opting in and past the 227 KB it may opt in to
     (streamed in chunks): found, kind and index equal, t bit-equal;
 21. the third main path: the full-parameter fwd+bwd of data/scene.json
     at 800x800 depth SJ_GRAD_DEPTH (10 tiles of 65,536 rays, one tangent
     pass; loss = image mean), driven with every count at 0 just before: all
     five leaves finite and nonzero, the fog's isotropic albedo row
     nonzero, K2 once per tile, K3 and K5 launched, the loss equal to the
     mean of the image render_pass draws (rtol 1e-5), the color gradient
     against a central difference of that mean (eps 1e-2, rtol 1e-2), a
     second pass
     at the same key equal in loss and in the color, images and
     metal-albedo gradients bit for bit (fuzz and IR too, or else held
     to the card's two-key noise floor); then timings: ms per pass
     (CUDA events), segments per second counted untimed, the split into
     taped forward, sweep and tangent pass, K2 on one tile's rows bit for
     bit against its plain version on the CPU and repeatable, timed
     against its plain version, index_add_ and the bound, and the device's
     busy share over one profiled tile;
 22. the same for C6 at 512x512 depth 20 (4 tiles): leaves finite, the
     color gradient nonzero, the loss the image mean, K6 launched and K5
     not, the repeat equal;
 23. at an equal t the TPU's kind order decides on the card: a rect and a
     sphere (K1) win over a triangle (K5), which wins off them;
 24. the CLI (ray_tracing_tpu_torch/cli.py) in-process on
     data/zy_scene.json at 1024x1024 depth CLI_DEPTH (its flags; the
     file's own renderer is 800x800 depth 20): 4 passes in one run with
     --checkpoint and --stats, then 2 passes and a resumed run to 4 --
     checkpoint sums
     np.array_equal, BMP files byte-equal, K1 launched alike in both and
     once per tile and bounce run; --stats' per-pass seconds and
     segments/s printed;
 25. ``python -m ray_tracing_tpu_torch.cli`` in a subprocess, 1 pass at
     1024x1024 depth CLI_DEPTH on the card: a PNG (decoded here, without
     Pillow) with a --profile Chrome trace that parses as JSON (whether it
     names K1 is printed), then an HDR that reads back finite and
     non-negative;
 26. Renderer.render_to_noise on C6 at 512x512 depth 20 (checks at 8 and
     16 passes, target NOISE_TARGET): the image equals the sum of
     render(fold_in(key, i)) for i < n, accumulated on the card in the
     same order, over n, bit for bit; rel_err finite and positive; K6
     launched;
 27. the gallery's C3 (scenes.earth_sphere, K1) and C4 (scenes.bunny,
     K5) at 512x512 depth 20: K1 and K5 against their plain versions on
     the 512x512 camera rays, one pass each finite, non-negative, with a
     mean in C3_MEAN / C4_MEAN and deterministic, ms per pass, and the
     kernel timed on the busiest camera tile against its plain version
     and bound;
 28. the train step of parallel/mesh.py: make_prb_train_step_all_direct
     on zy at 1024x1024 depth GRAD_DEPTH, one process, from wall colors at
     0.5 toward a target rendered at the true parameters under the step's
     own key (lr TRAIN_LR): one step on every leaf, finite, K1 launched
     and K2 for one sweep scatter per tile (the card's tile: the whole
     image), equal to params - lr g with g from
     tiled_loss_and_grad called directly at the step's tile (the color-linear
     leaves torch.equal, fuzz and IR to rtol 1e-4), and the loss change
     its color-linear and its whole update make; a witness of the fuzz
     and IR gradients (scalar_witness): the per-pixel derivatives of
     the loss by forward AD add up to the step's, and at least
     WITNESS_PIXELS of the pixels with a nonzero one meet the central
     difference of their term at h = 2e-6, 1e-4 or the step's own,
     with the loss's rise on either side of the step and IR's with the
     reflect/refract choice held; then three SGD steps of the
     color-linear leaves (tiled_loss_and_grad with scalar_rows=((),
     ()): fuzz and IR held), every loss finite and the third below the
     first; ms per step (CUDA events) and segments/s;
 29. the same step under distributed.initialize("nccl", world_size=1,
     rank=0, a file:// rendezvous under build/): its parameters and loss
     torch.equal to phase 28's first step;
 30. the autograd surface: prb_radiance_all on the same rays, the same
     L2 loss, loss.backward() -- the loss equal to the direct step's and
     the gradients to phase 28's by-hand pass (color-linear leaves
     torch.equal, fuzz and IR to rtol 1e-4); forward and backward ms;
     one make_prb_train_step_all step against phase 28's first step;
 31. the fit examples (ray_tracing_tpu_torch/examples/) on the card at
     reduced steps: each prints its final line, fit_geometry's error
     falls below its initial error and fit_materials' loss falls;
 32. the weekend (ray_tracing_tpu_torch/examples/weekend_scene.py at
     WEEKEND_SEED: 485 spheres, 0 rects, no light) built with the port's
     editor, written to its project JSON and opened again, generate(doc)
     -> v4ray.Renderer(..., device="cuda") -> await render() at
     1200x800 depth 50: K1 against its plain version on its 485-sphere,
     0-rect table for the 960,000 camera rays, the busiest camera tile
     and 65,536 secondary rays off its sphere hits (found, kind, idx
     equal, t bit-equal); three façade passes (a warm-up and two timed
     with CUDA events) driven with every count at 0 just before: finite,
     non-negative, mean in WEEKEND_MEAN, K1 launched and no other phase-A
     kernel; render_with_stats at the third pass's key and depth
     WEEKEND_TILE_DEPTH at the card's tile (the whole 960,000 rays) and at
     the CPU rule's (8,192), torch.equal, timed, with the same segments (segments/s);
     K1 timed on the camera and secondary tiles against its plain version and its operations
     bound; the busy share of a profiled 320x200 pass (one tile);
 33. ProgressiveRenderController over a second façade renderer of the
     same scene, two passes in flight, on an empty build directory with
     K1's library unloaded, so two executor threads make the first K1
     launch together: exactly 4 passes, one nvcc run of intersect.cu, the
     accumulated mean equal to iterations 1-4 rendered one after another
     (rtol 1e-6: float32 summation order);
 34. the web editor: serve(port=0, device="cuda") in a thread, driven
     over HTTP on 127.0.0.1 (every status checked): /api/state,
     /api/registries, /api/edit edits (a close camera with shutter
     [0, 1], the default sphere moved, a sphere added) and
     /api/render?passes=2, then a moving sphere and a mesh on
     data/bunny.obj added and /api/render again, each with every count at
     0 just before (K1 the first; K4 and K5, not K1 or K6, the second),
     each decoded PNG equal to the façade's render of generate(doc,
     preview=True) at the same two keys tone-mapped as render_png does;
     K1, K4 (at the rays' shutter times) and K5 against their plain
     versions on the previews' 96x72 camera rays and timed there; undo
     and redo followed, two invalid edits answered 500 with a JSON error
     and the server going on, the project round trip through
     load_project.
 35. the gallery runner (ray_tracing_tpu_torch/examples/render_baselines.py)
     in-process at GALLERY_ARGS (C1 64^2 1 spp ... C5 256^2 16 spp, the
     default depth), one configuration a call into one directory, every
     count at 0 just before each: stats.json holds all six with the JAX
     script's keys, each PNG decodes to its size (no Pillow), each mean
     in GALLERY_MEAN, each configuration launched its kernels and no
     other (C1 K3 and K5, C2/C3/C5 K1, C4 K1 and K5, C6 K1 and K6), and
     each of those kernels against its plain version on the
     configuration's own first-pass camera rays, timed there; then C6's
     host compile (79,488 triangles) and its parts, apart from its
     passes;
 36. the motion-blur demo (examples/motion_blur.py) at 96^2, 4 spp: the
     PNG decodes, the mean in MB_MEAN, K4 launched and K1 not; K4
     against its plain version on the demo's first-pass camera rays;
 37. the BVH walk (ops/bvh.py, plain PyTorch) on C4's bunny built with
     its BVH (scenes.bunny(bvh=True): no sweep or cluster tables):
     against K5 on the busiest 65,536-ray camera tile and 65,536
     secondary rays off its hits (found equal, idx equal but at t ties,
     which are counted, t to rtol 1e-5), ms per walk and its steps
     (each one host read); a 128^2 depth-1 pass through the walk
     torch.equal to the sweep's; 128^2 depth-20 passes at tiles 4,096
     and 65,536, torch.equal, finite, with a mean in C4_MEAN, K1
     launched and no sweep, timed beside the sweep's pass (K5
     launched); K1 and K5 against their plain versions on those passes'
     camera rays;
 38. ``python bench_scaling_torch.py --devices 1`` (one NCCL rank,
     16,384 zy rays, depth 10, 3 passes) as a subprocess: its line
     carries every key of bench_scaling.py's line, sharding_overhead
     finite, the rank's color gradient and segments equal to the
     unsharded run's, K1 and K2 launched in the timed passes; then, in
     this process, K1 against its plain version on the harness's rank-0
     rays and K2 against scatter_add_plain on the rows of one fwd+bwd of
     them, each timed there (K2 beside index_add_);
 39. the headline bench: bench_torch.main(passes=1, reps=1) at its own
     1024x1024, depth 20, tiles of 65,536 (a count, a warm-up and one
     timed pass), driven with every count at 0 just before: the record
     has exactly bench.py's keys, metric, unit and mode and a finite
     positive value; its segments equal traced_segments at key 1; its
     loss and five gradient leaves equal grad_pass at key 1, torch.equal;
     K1 launched and K2 called once per tile of both passes; then K1
     against its plain version on the pass's first camera tile and K2 on
     that tile's depth-20 sweep rows (bit for bit against the CPU,
     repeated), each timed there (K2 beside index_add_);
 40. the perf ladder (tools/perf/ladder_torch.py): its three stages, one
     round at 1024x1024 depth GRAD_DEPTH, with every count at 0 just
     before (K1 launched, K2 once per tile of each colors and full
     pass); colors and full at key 1 give the same loss and color-linear
     leaves, torch.equal, and colors no fuzz or IR gradient;
 41. tools/perf/profile_pass_torch.py on one tile of the full stage at
     depth GRAD_DEPTH, in a fresh process: exit 0 (every kernel family's
     profiled launches equal its wrapper's counter), K1 and K2 listed;
     then the two mesh tails of mesh_strategy: TAIL_COPIES offset bunnies
     (34,776 triangles) without cluster tables take "sweep" (K5 over the
     whole table) in a TAIL_SIZE^2 depth-TAIL_DEPTH render with every
     count at 0 just before (K5 launched, K6 not), K5 against its dense
     plain version on that render's camera rays and on rays aimed at the
     bunnies (t bit-equal), timed against its bound; C4's bunny without
     sweep constants takes "brute" (plain PyTorch): a BRUTE_SIZE^2
     depth-1 render finite and repeated torch.equal with no sweep
     launched, its depth-2 mean within 1e-3 of K5's, its phase-A winners
     equal K5's (t to BRUTE_RTOL, the triangle equal but at ties);
 42. multicard_torch.py as a subprocess: one NCCL rank on each card, up
     to MULTICARD_RANKS, zy at 1024x1024 depth GRAD_DEPTH (the kernels
     built here beforehand; every rank only loads them): the rank count
     and backend printed; on rank 0 the sharded image torch.equal to
     world 1's and its K1 launches summed over the ranks equal to world
     1's, the direct step within the one-card bound of world 1's, its
     traced segments and K2's calls summed over the ranks equal to world
     1's, the autograd step equal to the direct step (color-linear leaves
     bit for bit), the color-only and dense steps finite, moving the
     colors and within the bound; no two ranks on one card; on every rank
     K1 and K2 against their plain versions on its own first tile by
     path_kernels, compare_k2 and time_k2 (t bit-equal; K2 bit-equal to
     the CPU), timed there; launches of each rank's direct step, counted
     from 0.
Every kernel time comes with its bound (bound()): the larger of its
operations over the float32 peak and its bytes over the memory rate,
counted from this run's inputs (phase_a_bound: one object ray per ray
and distinct transform of a table; k2_bound: the mask of every row, the
texel of each masked row, the contribution of each live row and the
sums of each touched texel).  K5 and K6 share one (sweep_bound): the
(ray, 128-triangle cluster) pairs that any front-to-back sweep needs,
those whose box the ray enters before its own hit
(cuda_triangles.needed_cluster_pairs).
The last lines are a JSON kernel record (K1 once per zy path, with the
launches of the forward render of phase 3 and of the fwd+bwd of phase
7, K2 with the calls of phase 7 (two launches each) and the time of
index_add_ on its rows, K3
and K5 with those of phase 11, K6 with those of phase 16, K4 with those
of phase 18; K2, K3 and K5 again with the launches of phase 21; K1 on
C6's table with the launches of phase 16 and of phase 22, K2 and K6 with
those of phase 22; K1 with those of the CLI's straight run (phase 24),
K6 with those of render_to_noise (phase 26), K1 on C3 and K5 on C4 with
those of their pass in phase 27, K1 and K2 with those of phase 28's
full-parameter step, K1 with those of phase 32's three façade passes,
K1, K4 and K5 with those of phase 34's /api/render requests, each
kernel of each gallery configuration with the launches of its run in
phase 35, K4 with those of phase 36's demo, K1 with those of each of
phase 37's passes through the BVH walk and K5 with those of its sweep
pass, K1 and K2 with rank 0's launches in the harness's timed passes
(phase 38), K1 and K2 with the launches of the bench's run (phase 39),
K5 with those of the sweep tail's render (phase 41), and K1 and K2 of
each rank of phase 42 with the launches of that rank's direct step;
each of phases 35-42's entries with the kernel held against its plain
version and timed on that path's own rays), the card's name
and power limit, and a JSON device record.  Launch counts
are read only around single-threaded runs (phase 33's two threads
count approximately and are not recorded).
"""

from __future__ import annotations

import base64
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE, DEPTH, TILE = 1024, 20, 65536  # zy at full size, as bench.py measures it
SJ_SIZE, SJ_DEPTH = 800, 50  # data/scene.json at its own settings
SJ_MEAN = (0.55, 0.65)  # per-pass image mean at 800^2 (JAX CPU renders: 0.58-0.61)
C6_SIZE = 512  # C6 (examples/render_baselines.py:scene_c6) at its own 512^2, default depth 20
# per-pass image mean; tests/test_torch_clusters.py holds JAX's 32^2 renders inside it
C6_MEAN = (0.34, 0.39)
GALLERY_SIZE = 512  # C3 and C4 (examples/render_baselines.py:scene_c3, scene_c4), default depth 20
# per-pass image means; tests/test_torch_gallery.py holds JAX's 32^2 renders inside them
C3_MEAN = (0.42, 0.49)
C4_MEAN = (0.34, 0.40)
# render_to_noise's target on C6 (phase 26): below what 16 passes reach, so
# the run takes both checks (8, 16) and stops at max_passes
NOISE_TARGET = 0.01
MB_SIZE, MB_DEPTH = 384, 8  # examples/motion_blur.py at its own settings
# per-pass image mean, from JAX CPU renders without XLA's fusion (jax.disable_jit):
# jitted XLA-CPU fuses p = ro + rd t into an FMA, which flips the checker floor's
# cells on its zero plane (ROADMAP Queue 3); tests/test_torch_motion.py holds
# JAX's unfused 32^2 renders inside this range
MB_MEAN = (0.34, 0.40)
# The least time a kernel could take: the H100 SXM data sheet's float32
# rate outside the tensor cores and its memory rate.  Operations per test,
# counted from the plain version's arithmetic (products, sums, divisions,
# square roots; compares left out):
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
SPHERE_FLOPS = 20  # oc, half_b, c, disc, sqrt, two roots
RECT_FLOPS = 36  # plane t, then both in-plane coordinates
TF_FLOPS = 45  # an object ray: inv ro + inv_t, inv rd, its norm, the division
MOTION_FLOPS = 6  # c + t_ray v
K2_KERNELS = 2  # kernels one K2 call launches (place, sum)
# the weekend (examples/weekend_scene.py, its own seed 0: 485 spheres, no
# rect, no light) at its own 1200x800 depth 50
WEEKEND_SEED, WEEKEND_SIZE = 0, (1200, 800)
# per-pass image mean at 1200x800; JAX CPU renders of the same document
# (v4ray_tpu, iterations 1-8) give 0.3787-0.3809 at 120x80 and 0.3674-0.3809
# at 48x32 (PERF.md); tests/test_torch_editor.py holds JAX's 48x32 renders
# inside this range
WEEKEND_MEAN = (0.36, 0.40)
# the depth of phase 32's renders at two tiles: at the weekend's own 50 the
# one at 8,192 took 30.7 s (PERF.md)
WEEKEND_TILE_DEPTH = 10
WEB_PASSES = 2  # passes of each /api/render of phase 34
# the depth of the CLI's runs (phases 24-25): they check its flags, resume
# and file formats, and at the main path's depth 20 took 133-204 s of the
# script's 1,200 s (zy's mean hardly moves with depth: 0.175-0.185 at 4-5,
# 0.184-0.190 at 20, in CPU renders at 96^2)
CLI_DEPTH = 5
# the depth of the fwd+bwd and train paths (phases 6-8, 21 and 28-30): at
# the main paths' depths (zy 20, scene.json 50) they took 500 s of the
# script's 912 s on an H100 (PERF.md); a zy pass takes about 3x its
# depth-5 time (forward: 4.7 s against 1.5 s), though its rays trace 3.8
# segments on average to depth 20.  Their checks compare one path with
# another at one depth and hold no range set at the main paths' depths
GRAD_DEPTH, SJ_GRAD_DEPTH = 5, 10
GALLERY_ARGS = ("--res-scale", "0.25", "--spp-scale", "0.0625")  # sizes 64-256, spp 1-16
# the size and spp of each configuration at GALLERY_ARGS, and its image
# mean: the JAX script's CPU run at the same flags and keys gives C1
# 0.5952, C2 0.1879, C3 0.4530, C4 0.3724, C5 0.1885, C6 0.3653 (PERF.md);
# tests/test_torch_baselines.py holds the port against JAX at 16^2
GALLERY_RUNS = {"C1": (64, 1), "C2": (128, 4), "C3": (128, 4), "C4": (128, 8),
                "C5": (256, 16), "C6": (128, 2)}
GALLERY_MEAN = {"C1": (0.50, 0.70), "C2": (0.16, 0.22), "C3": (0.41, 0.50),
                "C4": (0.34, 0.41), "C5": (0.16, 0.22), "C6": (0.33, 0.40)}
MB_DEMO = ("--size", "96", "--spp", "4")  # the motion demo at 96^2, 4 spp, depth 8
WALK_SIZE = 128  # the BVH walk's passes on C4 (phase 37)
WALK_TILES = (4096, 65536)  # the JAX package's BVH tile cap (a TPU measurement) and the CPU's
COLOR_LINEAR = ("color", "images", "metal_albedo")  # the leaves K2 accumulates
TRI_FLOPS = 40  # det, 1/det, u, v, t of the triple-product form
SLAB_FLOPS = 12  # a cluster AABB's six differences and six products


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def reset_counts() -> None:
    """Set every kernel's launch count to 0, just before a path runs."""
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct

    ci.LAUNCHES = ci.TF_LAUNCHES = ci.MOTION_LAUNCHES = cs.LAUNCHES = 0
    ct.LAUNCHES = ct.CL_LAUNCHES = 0


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_device(fn):
    """Run ``fn()`` once under torch.profiler; returns (wall ms, {kernel
    name: (launches, device ms)}), the kernels empty when the profiler
    saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the raw trace: building prof.events() for a pass of ~300k kernels
    # and their CPU ops takes minutes of host time
    try:
        seen = [(e.name(), e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA]
    except AttributeError:  # a profiler without kineto results
        seen = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
                if e.device_type == DeviceType.CUDA]
    kernels = {}
    for name, ms in seen:
        n, total = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, total + ms)
    return wall_ms, kernels


def per_launch(kernels, kernel_name: str = ""):
    """Device ms per launch of the kernels of a profile_device trace whose
    name holds ``kernel_name`` (all of them with ""), over the launches
    the profiler saw: after an earlier session it can miss the first
    ctypes launch of the next one, so dividing by the calls made would
    undercount (by 1/3 in a 3-call session).  "not measured" where it saw
    none."""
    seen = [(n, ms) for name, (n, ms) in kernels.items() if kernel_name in name]
    launches = sum(n for n, _ in seen)
    return sum(ms for _, ms in seen) / launches if launches else "not measured"


def profile_pair(kernel_fn, plain_fn, calls: int, kernel_name: str):
    """Device ms of a kernel per launch (per_launch) and of its plain
    version per call, from one torch.profiler session that alternates
    them (a session of the ctypes-launched kernel alone has come back
    empty): events whose name holds ``kernel_name`` are the kernel's, all
    others the plain version's.  "not measured" where the profiler saw
    none."""
    _, kernels = profile_device(lambda: [(kernel_fn(), plain_fn()) for _ in range(calls)])
    seen = sum(n for name, (n, _) in kernels.items() if kernel_name in name)
    if seen < calls:  # the profiler fault of ROADMAP Queue 2 item 4: where it strikes
        print(f"[profiler] {kernel_name}: the session saw {seen} launches of {calls} calls")
    rest = [ms for name, (_, ms) in kernels.items() if kernel_name not in name]
    return per_launch(kernels, kernel_name), sum(rest) / calls if rest else "not measured"


def interior_rays(n: int, seed: int):
    """Secondary-bounce-like rays for zy and scene.json: origins inside the box,
    isotropic directions (numpy, seeded)."""
    import numpy as np
    import torch

    r = np.random.RandomState(seed)
    ro = r.uniform(1.0, 554.0, (n, 3)).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return torch.from_numpy(ro).cuda(), torch.from_numpy(rd).cuda()


def compare_phase_a(ci, tables, ro, rd, what: str, tag: str, t_ray=None):
    """K1, K3 or K4 (by the tables) against phase_a_plain (in 65,536-ray
    slices) on the same card tensors: found, kind and idx equal, t
    bit-equal.  Returns (largest |dt| over hit rays, kind, idx)."""
    import torch

    inf = float("inf")
    t, kind, idx = ci.phase_a_cuda(tables, ro, rd, 1e-3, inf, t_ray)
    torch.cuda.synchronize()
    plain = [ci.phase_a_plain(tables, ro[s:s + TILE], rd[s:s + TILE], 1e-3, inf,
                              None if t_ray is None else t_ray[s:s + TILE])
             for s in range(0, ro.shape[0], TILE)]
    pt, pkind, pidx = (torch.cat(x) for x in zip(*plain))
    found, pfound = kind >= 0, pkind >= 0
    both = found & pfound
    n_t = int((t[both] != pt[both]).sum())
    err = float((t[both] - pt[both]).abs().max()) if bool(both.any()) else 0.0
    print(f"[{tag}] {what}: {ro.shape[0]} rays, {int(found.sum())} hits; mismatches "
          f"found={int((found != pfound).sum())} kind={int((kind != pkind).sum())} "
          f"idx={int((idx != pidx).sum())} t(bits)={n_t}; max |dt| = {err!r}")
    check(torch.equal(kind, pkind) and torch.equal(idx, pidx) and torch.equal(t, pt),
          f"{what}: the kernel disagrees with its plain version")
    return err, kind, idx


def compare_k1(ci, tables, ro, rd, what: str, tag: str = "2") -> float:
    """K1 against phase_a_plain; returns the largest |dt| over hit rays."""
    before = ci.LAUNCHES
    err = compare_phase_a(ci, tables, ro, rd, f"K1 vs plain, {what}", tag)[0]
    check(ci.LAUNCHES == before + 1, "the plain tables launched K1")
    return err


def compare_k2(cs, p: int, segments, what: str, tag: str = "6") -> float:
    """K2 into a zeroed (p, 3) table on the card, twice, against
    scatter_add_plain run on the CPU over the same rows: both runs equal
    it bit for bit.  Returns the largest |difference| (0.0)."""
    import torch

    zeros = torch.zeros((p, 3), dtype=torch.float32)
    dev = segments[0][0].device
    got = cs.scatter_add_cuda(zeros.to(dev), segments)
    again = cs.scatter_add_cuda(zeros.to(dev), segments)
    torch.cuda.synchronize()
    want = cs.scatter_add_plain(zeros.clone(), [tuple(x.cpu() for x in s) for s in segments])
    err = float((got.cpu() - want).abs().max())
    live = torch.cat([m & (t >= 0) for t, _, m in segments])
    texel = torch.cat([t for t, _, _ in segments])
    n_live = int(live.sum())
    n_dup = n_live - int(torch.unique(texel[live]).numel())
    print(f"[{tag}] K2 vs plain on the CPU, {what}: {texel.shape[0]} rows in {len(segments)} "
          f"segment(s), {n_live} live, {n_dup} duplicate live rows; max |d| = {err!r}, "
          f"torch.equal {torch.equal(got.cpu(), want)}; two runs on the card torch.equal "
          f"{torch.equal(got, again)}")
    check(torch.equal(got.cpu(), want), f"K2 equals its plain version on the CPU, {what}")
    check(torch.equal(got, again), f"K2 repeats bit for bit, {what}")
    return err


def tile_segments(scene, ro, rd, k_trace, depth: int, ids_base: int = 0):
    """The rows ``(row, contrib, mask)`` of each stage of the tape sweep of
    the first 65,536-ray tile of a fwd+bwd pass (its rays' ids from
    ``ids_base``), with the image-mean cotangent, and the length of the
    gradient table [gimg | gcol | gmet] they go into: what K2 takes per
    tile."""
    import torch
    from ray_tracing_tpu_torch.render.prb import _grad_rows
    from ray_tracing_tpu_torch.render.prb_tape import sweep_segments, trace_taped

    rad, _, tape = trace_taped(scene, ro[:TILE], rd[:TILE], k_trace, depth, ids_base=ids_base)
    g = torch.full_like(rad, 1.0 / (ro.shape[0] * 3))
    return sweep_segments(scene, tape, rad, g), sum(_grad_rows(scene))


def motion_rays(n: int, seed: int):
    """Rays over the motion scene's floor toward its spheres and their
    shutter times (numpy, seeded), on the card."""
    import numpy as np
    import torch

    r = np.random.RandomState(seed)
    ro = r.uniform([-3, 0.1, -3], [3, 2.5, 3], (n, 3))
    rd = r.uniform([-1.5, 0.2, -0.5], [2.5, 0.7, 0.5], (n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return tuple(torch.from_numpy(x.astype(np.float32)).cuda()
                 for x in (ro, rd, r.uniform(0.0, 1.0, n)))


def grad_pass(params, scene, ro, rd, k_trace, tile_loss, depth: int = DEPTH, tile: int = TILE):
    """One full-parameter fwd+bwd pass by the port's gradient route
    (render/prb_scalar.py:tiled_loss_and_grad, bench.py:172-231's
    protocol): tiles under one trace key with ids_base, per tile the taped
    forward and its sweep, one global scalar_tangent_pass.  The loss is
    the summed per-tile losses over n*3, so every gradient is scaled by
    1/(n*3).  ``tile_loss(rad, rows)`` is the loss of the tile's rows.
    Returns (loss tensor, AllParams)."""
    from ray_tracing_tpu_torch.render.prb_scalar import tiled_loss_and_grad

    scale = 1.0 / (ro.shape[0] * 3)
    return tiled_loss_and_grad(lambda rad, rows: tile_loss(rad, rows) * scale, params, scene,
                               ro, rd, k_trace, depth, tile_size=tile)


def split_pass(params, scene, ro, rd, k_trace, depth: int = DEPTH, tile: int = TILE):
    """The same pass as grad_pass with the loss torch.sum, built from its
    pieces so that CUDA events split it: (taped forward ms, sweep ms,
    tangent pass ms)."""
    import torch
    from ray_tracing_tpu_torch.render.prb_scalar import _with_all, scalar_tangent_pass
    from ray_tracing_tpu_torch.render.prb_tape import tape_sweep, trace_taped

    ev = lambda: torch.cuda.Event(enable_timing=True)
    s = _with_all(scene, params)
    n = ro.shape[0]
    fwd, sweep, touches = [], [], []
    for start in range(0, n, tile):
        rows = slice(start, min(start + tile, n))
        e0, e1, e2 = ev(), ev(), ev()
        e0.record()
        rad, touched, tape = trace_taped(s, ro[rows], rd[rows], k_trace, depth, ids_base=start)
        e1.record()
        tape_sweep(s, tape, rad, torch.ones_like(rad))
        e2.record()
        fwd.append((e0, e1))
        sweep.append((e1, e2))
        touches.append(touched)
    e3, e4 = ev(), ev()
    e3.record()
    scalar_tangent_pass(params, scene, ro, rd, k_trace, depth, torch.ones_like(ro),
                        torch.cat(touches), tile_size=tile)
    e4.record()
    torch.cuda.synchronize()
    total = lambda pairs: sum(a.elapsed_time(b) for a, b in pairs)
    return total(fwd), total(sweep), e3.elapsed_time(e4)


def image_mean(scene, camera, key, size: int = SIZE, depth: int = DEPTH) -> float:
    """Mean of the size x size image at ``key`` by the renderer's own
    entry (render_pass: its own camera rays, the tiles and ray ids of
    grad_pass), summed in float64."""
    from ray_tracing_tpu_torch.render.renderer import render_pass

    img = render_pass(scene, camera, key, width=size, height=size, max_depth=depth,
                      antialias=True, tile_size=TILE)
    return float(img.double().sum()) / img.numel()


def dense_pass(renderer, key):
    """(image, traced segments) of ``renderer``'s pass at ``key`` by the
    dense loop integrator.trace, over the pass's own camera rays and ray
    ids in one call: what the compacted renderer must equal bit for bit."""
    from ray_tracing_tpu_torch.models.camera import camera_rays, stamp_shutter
    from ray_tracing_tpu_torch.render.integrator import trace

    p = renderer.param
    ro, rd, _, k_trace = camera_rays(renderer.camera, renderer._as_key(key), p.width, p.height,
                                     renderer.antialias)
    rad, segments = trace(stamp_shutter(renderer.scene, renderer.camera), ro, rd, k_trace,
                          renderer.max_depth, with_stats=True)
    return rad.reshape(p.height, p.width, 3), int(segments)


def traced_segments(scene, ro, rd, k_trace, depth: int = DEPTH) -> int:
    """The segments traced for the rays (ro, rd) with the tiles and ray
    ids of grad_pass, forward only.  At a fixed key the paths do not
    depend on colors, so they are those of every pass at this key,
    counted as bench.py counts them."""
    from ray_tracing_tpu_torch.render.integrator import trace_compacted

    return sum(int(trace_compacted(scene, ro[s:s + TILE], rd[s:s + TILE], k_trace, depth,
                                   with_stats=True, ids_base=s)[1])
               for s in range(0, ro.shape[0], TILE))


def timed_renders(renderer, keys):
    """renderer.render(k) for each key, the second and later ones timed
    with CUDA events (the first is the warm-up); returns (images, ms)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    images, pass_ms = [renderer.render(keys[0])], []
    for key in keys[1:]:
        start.record()
        images.append(renderer.render(key))
        end.record()
        torch.cuda.synchronize()
        pass_ms.append(start.elapsed_time(end))
    return images, pass_ms


def repeat_report(tag: str, loss, grads, loss2, grads2) -> dict:
    """Print whether a second pass at the same key repeats the loss and
    each gradient leaf bit for bit (and by how much it differs where it
    does not); check the loss.  Returns {leaf: torch.equal}."""
    import torch
    from ray_tracing_tpu_torch.render.prb_scalar import AllParams

    equal = {f: bool(torch.equal(getattr(grads2, f), getattr(grads, f)))
             for f in AllParams._fields}
    rel = {f: float((getattr(grads2, f) - getattr(grads, f)).abs().max()
                    / getattr(grads, f).abs().max().clamp_min(1e-30))
           for f in AllParams._fields if not equal[f]}
    print(f"[{tag}] second pass, same key: loss equal {bool(torch.equal(loss, loss2))}; "
          f"gradients torch.equal per leaf {equal}; max |d| / max |g| of the others {rel} "
          f"(color, images and metal albedo: K2, in row order)")
    check(bool(torch.equal(loss, loss2)), "the loss repeats at the same key")
    return equal


def gradient_phases(scene, bundle, smi: str) -> dict:
    """Phases 6-8 on the card: K2 against its plain version, the
    full-parameter fwd+bwd of zy at 1024^2 depth GRAD_DEPTH, and its
    timings.
    Returns the numbers the kernel record needs."""
    import numpy as np
    import torch
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.models.scene import MAT_DIFFUSE_LIGHT, MAT_METAL
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.render.prb_scalar import AllParams, _with_all, params_of
    from ray_tracing_tpu_torch.render.renderer import render_pass

    dev = scene.device
    n = SIZE * SIZE
    p_texels = scene.textures.images[..., 0].numel()
    cam = Camera.build(bundle.camera, 1.0).to(dev)
    key = rng.key(0)
    ro, rd, _, k_trace = camera_rays(cam, key, SIZE, SIZE, True)

    # 6. K2 against its plain version on the CPU
    r = np.random.RandomState(0)
    rows = 20 * TILE
    live = r.rand(rows) < 0.05
    texel = np.where(r.rand(rows) < 0.5, r.randint(0, 1024, rows), r.randint(0, p_texels, rows))
    # positive, as the rows of an image-mean gradient are
    contrib = torch.from_numpy(r.uniform(0.0, 1.0, (rows, 3)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(live).to(dev)
    k2_err = compare_k2(cs, p_texels, [(torch.from_numpy(texel.astype(np.int32)).to(dev), contrib,
                                        mask)], f"{rows:,} rows (seed 0), duplicates")
    unique = np.full(rows, -1, np.int64)
    unique[live] = r.permutation(p_texels)[: int(live.sum())]
    k2_err = max(k2_err, compare_k2(cs, p_texels, [(torch.from_numpy(unique.astype(np.int32)).to(dev),
                                                    contrib, mask)], "the same rows, no duplicates"))
    tile_rows, p_table = tile_segments(scene, ro, rd, k_trace, GRAD_DEPTH)
    for stage, rows_s in enumerate(tile_rows):
        k2_err = max(k2_err, compare_k2(cs, p_table, [rows_s], f"zy tile 0 sweep stage {stage}"))
    k2_err = max(k2_err, compare_k2(cs, p_table, tile_rows,
                                    "zy tile 0 sweep, its stages in one call"))
    n_tile = sum(t.shape[0] for t, _, _ in tile_rows)
    all_live = (torch.from_numpy(np.where(r.rand(n_tile) < 0.5, r.randint(0, 1024, n_tile),
                                          r.randint(0, p_texels, n_tile)).astype(np.int32)).to(dev),
                torch.from_numpy(r.uniform(0.0, 1.0, (n_tile, 3)).astype(np.float32)).to(dev),
                torch.ones(n_tile, dtype=torch.bool, device=dev))
    k2_err = max(k2_err, compare_k2(cs, p_texels, [all_live],
                                    f"{n_tile:,} rows all live (half on 1,024 texels)"))

    # 7. the gradient path at full size
    params = params_of(scene)
    reset_counts()
    t0 = time.perf_counter()
    loss, grads = grad_pass(params, scene, ro, rd, k_trace, lambda rad, rows: torch.sum(rad),
                            GRAD_DEPTH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1_launches": ci.LAUNCHES, "k2_launches": cs.LAUNCHES}
    check(cs.LAUNCHES == n // TILE, "K2 is called once per tile")
    norms = {f: float(torch.linalg.vector_norm(getattr(grads, f))) for f in AllParams._fields}
    print(f"[7] zy {SIZE}^2 depth {GRAD_DEPTH} fwd+bwd ({n // TILE} tiles of {TILE}, one tangent "
          f"pass): loss {float(loss)!r} in {wall:.2f} s; K1 launches {ci.LAUNCHES}, "
          f"K2 launches {cs.LAUNCHES}; gradient norms {norms}")
    for f in AllParams._fields:
        g = getattr(grads, f)
        check(g.shape == getattr(params, f).shape, f"{f} gradient shape")
        check(bool(torch.isfinite(g).all()), f"{f} gradient finite")
        check(norms[f] > 0.0, f"{f} gradient nonzero")
    check(ci.LAUNCHES > 0 and cs.LAUNCHES > 0, "the gradient path launched K1 and K2")
    mean0 = image_mean(scene, cam, key, depth=GRAD_DEPTH)
    check(abs(mean0 - float(loss)) <= 1e-5 * mean0, "the gradient pass's loss is the image mean")
    segments = traced_segments(scene, ro, rd, k_trace, GRAD_DEPTH)

    # colors against a central difference: at a fixed key the paths do not
    # depend on colors, so the image mean is a polynomial in them
    d = grads.color / torch.linalg.vector_norm(grads.color)
    eps = 1e-2
    at = lambda c: image_mean(_with_all(scene, params._replace(color=c)), cam, key,
                              depth=GRAD_DEPTH)
    fd = (at(params.color + eps * d) - at(params.color - eps * d)) / (2 * eps)
    gd = float((grads.color * d).sum())
    print(f"[7] color gradient along g/|g|: g.d {gd!r}, central difference (eps {eps}) {fd!r}, "
          f"rel err {abs(fd - gd) / abs(gd)!r}")
    check(abs(fd - gd) <= 1e-2 * abs(gd), "color gradient matches the central difference, rtol 1e-2")

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    loss2, grads2 = grad_pass(params, scene, ro, rd, k_trace, lambda rad, rows: torch.sum(rad),
                              GRAD_DEPTH)
    end.record()
    torch.cuda.synchronize()
    pass_ms = [start.elapsed_time(end)]  # phase 8's first timing
    equal = repeat_report("7", loss, grads, loss2, grads2)
    for f in COLOR_LINEAR:
        check(equal[f], f"the {f} gradient (K2) repeats bit for bit")
    for f in ("fuzz", "ir"):
        check(torch.allclose(getattr(grads2, f), getattr(grads, f), rtol=1e-4, atol=1e-8),
              f"{f} gradient repeats to rtol 1e-4")

    # three SGD steps of an L2 fit (examples/fit_materials.py:97-141): the
    # target is rendered under another key; colors (emitters pinned), metal
    # albedo, fuzz and IR start perturbed and are clipped to their boxes
    mat = scene.materials
    pinned = torch.zeros_like(params.color[:, :1], dtype=torch.bool)
    pinned[mat.tex[mat.mtype == MAT_DIFFUSE_LIGHT].long()] = True
    is_metal = mat.mtype == MAT_METAL
    fit = params._replace(
        color=torch.where(pinned, params.color, 0.5),
        metal_albedo=torch.where(is_metal[:, None], 0.5, params.metal_albedo),
        fuzz=torch.where(is_metal, 0.05, params.fuzz),
        ir=torch.where(params.ir > 1.0, 1.2, params.ir),
    )
    target = render_pass(scene, cam, rng.key(1), width=SIZE, height=SIZE, max_depth=GRAD_DEPTH,
                         antialias=True, tile_size=TILE).reshape(n, 3)
    lr = 1.0
    for step in range(3):
        loss_s, g = grad_pass(fit, scene, ro, rd, k_trace,
                              lambda rad, rows: torch.sum((rad - target[rows]) ** 2), GRAD_DEPTH)
        g = g._replace(color=torch.where(pinned, 0.0, g.color))
        step_norms = {f: float(torch.linalg.vector_norm(getattr(g, f))) for f in AllParams._fields}
        print(f"[7] SGD step {step}: L2 loss {float(loss_s)!r}, gradient norms {step_norms}")
        check(np.isfinite(float(loss_s)) and all(np.isfinite(v) for v in step_norms.values()),
              f"SGD step {step} finite")
        fit = AllParams(*(p - lr * gp for p, gp in zip(fit, g)))
        fit = fit._replace(
            color=torch.where(pinned, fit.color, fit.color.clamp(0.0, 1.0)),
            images=fit.images.clamp(0.0, 1.0),
            metal_albedo=fit.metal_albedo.clamp(0.0, 1.0),
            fuzz=fit.fuzz.clamp(0.0, 1.0),
            ir=fit.ir.clamp(1.0, 3.0),
        )
    print(f"[7] after 3 steps: fuzz {fit.fuzz[is_metal].tolist()} (true "
          f"{params.fuzz[is_metal].tolist()}), ir {fit.ir[params.ir > 1].tolist()} "
          f"(true {params.ir[params.ir > 1].tolist()})")

    # 8. timings, CUDA events after the warm-up above (the second pass of
    # phase 7 and one more); the segments of the pass were counted untimed
    # on the same keys in phase 7 (bench.py:253-273)
    start.record()
    grad_pass(params, scene, ro, rd, k_trace, lambda rad, rows: torch.sum(rad), GRAD_DEPTH)
    end.record()
    torch.cuda.synchronize()
    pass_ms.append(start.elapsed_time(end))
    fwd_ms, sweep_ms, tangent_ms = split_pass(params, scene, ro, rd, k_trace, GRAD_DEPTH)
    k2 = time_k2(cs, p_table, tile_rows, dev, "8", "zy")
    tile_wall, tile_dev = profile_device(
        lambda: grad_pass(params, scene, ro[:TILE], rd[:TILE], k_trace,
                          lambda rad, rows: torch.sum(rad), GRAD_DEPTH))
    mean_ms = sum(pass_ms) / len(pass_ms)
    print(f"[8] card: {smi}")
    print(f"[8] ms per {SIZE}^2 depth-{GRAD_DEPTH} fwd+bwd pass: {pass_ms!r} (mean {mean_ms!r}); "
          f"{segments} traced segments (counted untimed, bench.py's unit): "
          f"{segments / (mean_ms / 1e3)!r} segments/s; 1024^2 rays/s "
          f"{n / (mean_ms / 1e3)!r}")
    print(f"[8] split of one pass: taped forward {fwd_ms!r} ms, sweep {sweep_ms!r} ms, "
          f"tangent pass {tangent_ms!r} ms")
    if tile_dev:
        busy = sum(ms for _, ms in tile_dev.values())
        print(f"[8] profiled fwd+bwd of one {TILE}-ray tile: wall {tile_wall!r} ms, device busy "
              f"{busy!r} ms ({busy / tile_wall!r} of wall), "
              f"{sum(c for c, _ in tile_dev.values())} device kernels")
        for name, (c, ms) in sorted(tile_dev.items(), key=lambda kv: -kv[1][1])[:8]:
            print(f"[8]   {ms!r} ms in {c} launches: {name[:90]}")
    else:
        print("[8] torch.profiler saw no device time: device share not measured")
    return dict(launches, k2_err=k2_err, k2_ms=k2["kernel"][0], k2_plain_ms=k2["plain"][0],
                k2_library_ms=k2["index_add_"][0], k2_bound=k2["bound"])


def k2_bound(cs, segments):
    """bound() of K2 over these rows: each row's mask byte, the table row
    of each masked row (4 B), the contribution of each live row (12 B) and
    each touched row's three sums read and written (24 B); three adds per
    live row.  The rows go into the one table [gimg | gcol | gmet], so the
    color and metal-albedo rows count as the texels do."""
    import torch

    rows = sum(t.shape[0] for t, _, _ in segments)
    masked = sum(int(m.sum()) for _, _, m in segments)
    live = torch.cat([t[m & (t >= 0)] for t, _, m in segments])
    touched = int(torch.unique(live).numel())
    return bound(3 * live.numel(), rows + 4 * masked + 12 * live.numel() + 24 * touched)


def time_k2(cs, p: int, segments, dev, tag: str, scene_name: str) -> dict:
    """K2 on one tile's sweep rows (one call) against its plain version
    on the card, index_add_ and the deterministic index_put_ (one call
    each, on the live rows selected beforehand) and the empty kernel:
    CUDA-event ms per call (first and last in turns) and torch.profiler
    device ms per call.  Returns {name: (events ms, device ms)} and the
    bound."""
    import torch

    gt = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    before = cs.LAUNCHES
    idx = torch.cat([t[m & (t >= 0)] for t, _, m in segments]).long()
    vals = torch.cat([c[m & (t >= 0)] for t, c, m in segments])

    def put():
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            gt.index_put_((idx,), vals, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(was)

    stream = torch.cuda.current_stream(dev).cuda_stream
    floor = cs._library().empty_launch
    calls = {
        "plain": lambda: cs.scatter_add_plain(gt, segments),
        "kernel": lambda: cs.scatter_add_cuda(gt, segments),
        "index_add_": lambda: gt.index_add_(0, idx, vals),
        "index_put_ (deterministic)": put,
        "empty kernel": lambda: floor(stream),
    }
    events = {k: [] for k in calls}
    for name in list(calls) + list(reversed(calls)):
        events[name].append(cuda_ms(calls[name], 20 if name == "plain" else 50))
    device = {}
    for name, fn in calls.items():
        if name == "kernel":  # ctypes launches, paired with a PyTorch op
            device[name] = device_ms(fn, 10, "scatter_add_")
            if isinstance(device[name], float):
                device[name] *= K2_KERNELS
        elif name == "empty kernel":
            device[name] = device_ms(fn, 10, "empty_kernel")
        else:
            _, trace = profile_device(lambda: [fn() for _ in range(10)])
            device[name] = sum(ms for _, ms in trace.values()) / 10 if trace else "not measured"
    cs.LAUNCHES = before
    bnd = k2_bound(cs, segments)
    n_rows = sum(t.shape[0] for t, _, _ in segments)
    print(f"[{tag}] K2 on one {scene_name} tile's sweep rows ({len(segments)} segments in one "
          f"call, {n_rows} rows, {idx.numel()} live, {int(torch.unique(idx).numel())} of {p} "
          f"table rows touched): bound {bnd[0]!r} ms by {bnd[1]}")
    out = {"bound": bnd}
    for name in calls:
        ev = sum(events[name]) / len(events[name])
        share = (f", share {bnd[0] / device[name]:.4f} of the bound"
                 if isinstance(device[name], float) and name == "kernel" else "")
        print(f"[{tag}]   {name}: events {events[name]!r} ms (in turns), device "
              f"{device[name]!r} ms per call{share}")
        out[name] = (ev, device[name])
    return out


def bunny_rays(n: int, seed: int):
    """Rays from inside the box aimed at scene.json's bunny (x 250-360,
    y 30-190, z 140-270 after its transform), numpy seeded."""
    import numpy as np
    import torch

    r = np.random.RandomState(seed)
    ro = r.uniform(20.0, 535.0, (n, 3)).astype(np.float32)
    target = r.uniform([250, 30, 140], [360, 190, 270], (n, 3)).astype(np.float32)
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return torch.from_numpy(ro).cuda(), torch.from_numpy(rd).cuda()


def compare_k3(ci, tables, ro, rd, what: str) -> float:
    """K3 against phase_a_plain (in 65,536-ray slices) on the same card
    tensors; returns the largest |dt| over hit rays."""
    before = ci.TF_LAUNCHES
    err, kind, idx = compare_phase_a(ci, tables, ro, rd, f"K3 vs plain, {what}", "9")
    check(ci.TF_LAUNCHES == before + 1, "the transformed tables launched K3")
    on_cuboid = int(((kind == 2) & (idx < 6)).sum())
    print(f"[9]   {on_cuboid} winners on the rotated cuboid")
    check(on_cuboid > 0, f"K3 winners include the transformed rects on {what}")
    return err


def agree(tag: str, what: str, n: int, got, want) -> float:
    """Print and check that a sweep's (t, idx, found) equal a plain
    version's: found and idx equal, t bit-equal on hits.  Returns the
    largest |dt| over hits."""
    import torch

    t, idx, found = got
    pt, pidx, pfound = want
    both = found & pfound
    n_t = int((t[both] != pt[both]).sum())
    err = float((t[both] - pt[both]).abs().max()) if bool(both.any()) else 0.0
    print(f"[{tag}] {what}: {n} rays, {int(found.sum())} on the mesh "
          f"({float(found.float().mean()):.4f}); mismatches found={int((found != pfound).sum())} "
          f"idx={int((idx[both] != pidx[both]).sum())} t(bits)={n_t}; max |dt| = {err!r}")
    check(torch.equal(found, pfound) and torch.equal(idx[both], pidx[both]) and n_t == 0,
          f"{what}: the kernel disagrees with the plain version")
    return err


def sweep_stats(ct, stats, n: int, kc: int) -> str:
    """The per-warp list lengths, sweeps and swept pairs of a launch."""
    listed, sweeps, pairs = (int(x) for x in stats.tolist())
    warps = -(-n // ct.WARP_RAYS)
    return (f"per warp: {listed / warps:.2f} of {kc} clusters listed, {sweeps / warps:.2f} swept; "
            f"{pairs} (ray, cluster) pairs swept by a lane that could still hit them")


def compare_k5(ct, tr, ro, rd, what: str, tag: str = "10"):
    """K5 against triangle_sweep_plain (dense, in 65,536-ray slices);
    returns (largest |dt| over hit rays, (t, idx, found))."""
    import torch

    stats = torch.zeros(3, dtype=torch.int32, device=ro.device)
    before = ct.LAUNCHES
    got = ct.triangle_sweep_cuda(tr.sw_table, tr.sw_aabb, tr.sw_origin, ro, rd, 1e-3,
                                 float("inf"), stats)
    torch.cuda.synchronize()
    check(ct.LAUNCHES == before + 1, "K5 launched")
    plain = [ct.triangle_sweep_plain(tr.sw_table, tr.sw_origin, ro[s:s + TILE], rd[s:s + TILE],
                                     1e-3, float("inf"))
             for s in range(0, ro.shape[0], TILE)]
    err = agree(tag, f"K5 vs plain (dense), {what}", ro.shape[0], got,
                [torch.cat(x) for x in zip(*plain)])
    pairs, _ = needed_work(ct, tr, ro, rd, got[0], got[2])
    print(f"[{tag}]   {pairs} needed (ray, cluster) pairs; "
          f"{sweep_stats(ct, stats, ro.shape[0], tr.sw_aabb.shape[0])}")
    check(float(got[2].float().mean()) > 0.01, f"more than 1 % of the rays hit the mesh on {what}")
    return err, got


def scene_json_phases(smi: str) -> dict:
    """Phases 9-13 on the card: K3 and K5 against their plain versions,
    the forward render of data/scene.json at 800^2 depth 50, its checks
    and timings.  Returns the numbers the kernel record needs."""
    import torch
    from ray_tracing_tpu_torch import Renderer, RendererParam, load_scene_json
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct
    from ray_tracing_tpu_torch.ops import rng

    dev = torch.device("cuda")
    bundle = load_scene_json(os.path.join(ROOT, "data", "scene.json"))
    check((bundle.renderer.width, bundle.renderer.height, bundle.renderer.max_depth)
          == (SJ_SIZE, SJ_SIZE, SJ_DEPTH), "scene.json's own settings are 800^2 depth 50")
    scene = bundle.scene.to(dev)
    print(f"[9] scene.json: {scene.n_triangles} triangles, {scene.n_rects} rects "
          f"(transformed: {scene.rects.has_transforms}), {scene.n_spheres} spheres, "
          f"{scene.n_medium} medium")

    # 9. K3 against its plain version
    tables = scene.phase_a
    cam = Camera.build(bundle.camera, 1.0).to(dev)
    ro, rd, _, _ = camera_rays(cam, rng.key(0), SJ_SIZE, SJ_SIZE)
    ro, rd = ro.contiguous(), rd.contiguous()
    k3_err = compare_k3(ci, tables, ro, rd, f"{SJ_SIZE}^2 scene.json camera rays")
    box_ro, box_rd = interior_rays(TILE, 0)  # scene.json's box is zy's
    k3_err = max(k3_err, compare_k3(ci, tables, box_ro, box_rd, f"{TILE} random rays (seed 0)"))

    # 10. K5 against its plain version (dense, no cull)
    tr = scene.triangles
    k5_err, cam_hit = compare_k5(ct, tr, ro, rd, f"{SJ_SIZE}^2 scene.json camera rays")
    b_ro, b_rd = bunny_rays(TILE, 0)
    k5_err = max(k5_err, compare_k5(ct, tr, b_ro, b_rd,
                                    f"{TILE} rays aimed at the bunny (seed 0)")[0])
    s_ro, s_rd = secondary_rays(tr, ro, rd, *cam_hit, TILE, 0)
    k5_err = max(k5_err, compare_k5(ct, tr, s_ro, s_rd,
                                    f"{TILE} secondary rays from the mesh hits (seed 0)")[0])
    # the camera-ray tile with the most mesh hits, timed below
    busiest = int(cam_hit[2][:TILE * (ro.shape[0] // TILE)].reshape(-1, TILE).sum(dim=1).argmax())
    c_ro, c_rd = ro[busiest * TILE:(busiest + 1) * TILE], rd[busiest * TILE:(busiest + 1) * TILE]

    # 11. the main path
    renderer = Renderer(RendererParam(SJ_SIZE, SJ_SIZE, max_depth=SJ_DEPTH), bundle.camera,
                        bundle.scene, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    images, pass_ms = timed_renders(renderer, range(3))  # phase 13's timings
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"k1": ci.LAUNCHES, "k3": ci.TF_LAUNCHES, "k5": ct.LAUNCHES}
    print(f"[11] rendered 3 passes of scene.json at {SJ_SIZE}^2 depth {SJ_DEPTH} (tile "
          f"{renderer.tile_size}) in {main_s:.2f} s; K1 launches {ci.LAUNCHES}, K3 launches "
          f"{ci.TF_LAUNCHES}, K5 launches {ct.LAUNCHES}")
    check(ci.TF_LAUNCHES > 0 and ct.LAUNCHES > 0, "the scene.json path launched K3 and K5")
    for k, img in enumerate(images):
        mean = float(img.double().mean())
        print(f"[11] pass {k}: mean {mean!r} max {float(img.max())!r}")
        check(img.shape == (SJ_SIZE, SJ_SIZE, 3) and img.device.type == "cuda",
              f"scene.json pass {k} shape/device")
        check(bool(torch.isfinite(img).all()) and bool((img >= 0).all()),
              f"scene.json pass {k} finite, >= 0")
        check(SJ_MEAN[0] < mean < SJ_MEAN[1], f"scene.json pass {k} mean {mean} in {SJ_MEAN}")
    check(torch.equal(images[0], renderer.render(0)), "scene.json render(0) twice is equal")
    print("[11] render(0) repeated: torch.equal")

    # 12. compaction equals the dense loop; the card agrees with the CPU
    small = RendererParam(128, 128, max_depth=SJ_DEPTH)
    small_renderer = Renderer(small, bundle.camera, bundle.scene, device="cuda")
    img_c, seg_c = small_renderer.render_with_stats(7)
    img_d, seg_d = dense_pass(small_renderer, 7)
    check(torch.equal(img_c, img_d) and seg_c == seg_d, "scene.json compacted equals dense")
    print(f"[12] 128^2 depth {SJ_DEPTH}: compacted == dense (torch.equal), {seg_c} segments each")
    tiny = RendererParam(32, 32, max_depth=1)
    on_card = Renderer(tiny, bundle.camera, bundle.scene, device="cuda").render(0).cpu()
    on_cpu = Renderer(tiny, bundle.camera, bundle.scene, device="cpu").render(0)
    share = float((on_card == on_cpu).all(dim=-1).float().mean())
    print(f"[12] 32^2 depth 1: {share:.6f} of pixels equal to the CPU render")
    check(torch.equal(on_card, on_cpu),
          "scene.json depth-1 image on the card equals the CPU render")

    # 13. timings (the passes: phase 11's renders 1 and 2)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _, segments = renderer.render_with_stats(20)
    end.record()
    torch.cuda.synchronize()
    stats_s = start.elapsed_time(end) / 1e3
    saved = (ci.LAUNCHES, ci.TF_LAUNCHES, ct.LAUNCHES)
    k3_args = (tables, box_ro, box_rd, 1e-3, float("inf"))
    k5_args = (tr.sw_table, tr.sw_aabb, tr.sw_origin, s_ro, s_rd, 1e-3, float("inf"))
    k3_plain = [cuda_ms(lambda: ci.phase_a_plain(*k3_args), 20)]
    k3_kernel = [cuda_ms(lambda: ci.phase_a_cuda(*k3_args), 100) for _ in range(2)]
    k3_plain.append(cuda_ms(lambda: ci.phase_a_plain(*k3_args), 20))
    plain5 = lambda: ct.triangle_sweep_plain(tr.sw_table, tr.sw_origin, s_ro, s_rd, 1e-3,
                                             float("inf"))
    k5_plain = [cuda_ms(plain5, 3)]
    k5 = time_sweep_tiles(ct, tr, ct.triangle_sweep_cuda, "triangle_sweep_kernel", (
        (f"camera-ray tile {busiest}", c_ro, c_rd), ("the bunny-aimed tile", b_ro, b_rd),
        ("the secondary tile", s_ro, s_rd)), "13")
    k5_plain.append(cuda_ms(plain5, 3))
    small_renderer.render(30)
    pass_wall, pass_dev = profile_device(lambda: small_renderer.render(31))
    dev_ms = dict(zip(("k3", "k3_plain"), profile_pair(
        lambda: ci.phase_a_cuda(*k3_args), lambda: ci.phase_a_plain(*k3_args), 10,
        "phase_a_kernel")))
    dev_ms["k5_plain (secondary tile)"] = profile_pair(
        lambda: ct.triangle_sweep_cuda(*k5_args), plain5, 3, "triangle_sweep_kernel")[1]
    ci.LAUNCHES, ci.TF_LAUNCHES, ct.LAUNCHES = saved
    print(f"[13] card: {smi}")
    print(f"[13] ms per {SJ_SIZE}^2 depth-{SJ_DEPTH} scene.json pass: {pass_ms!r} "
          f"(mean {sum(pass_ms) / len(pass_ms)!r})")
    print(f"[13] render_with_stats: {segments} segments in {stats_s!r} s = "
          f"{segments / stats_s!r} segments/s")
    print(f"[13] K3 on a {TILE}-ray tile: kernel {k3_kernel!r} ms, plain {k3_plain!r} ms "
          f"(plain, kernel, kernel, plain)")
    print(f"[13] K5's plain version on the secondary tile ({scene.n_triangles} triangles): "
          f"{k5_plain!r} ms by events (before and after the kernel's timings)")
    print(f"[13] device ms per call (torch.profiler; 'not measured' where it saw no device "
          f"time): {dev_ms!r}")
    busy_share(pass_dev, pass_wall, "13", f"128^2 depth-{SJ_DEPTH} scene.json pass")
    share = kernel_share(pass_dev, "triangle_sweep_kernel")
    if share:
        print(f"[13] K5 in that pass: {share[0]!r} ms in {share[1]} launches, {share[2]!r} of "
              f"device busy")
    k3_bound = phase_a_bound(ci, tables, TILE)
    launch_floor(cs, "13")
    k5_ms, _, k5_bound = k5["the secondary tile"]
    print(f"[13] bounds: K3 {k3_bound[0]!r} ms by {k3_bound[1]}, K5 (secondary tile) "
          f"{k5_bound[0]!r} ms by {k5_bound[1]}")
    return dict(launches=launches, k3_err=k3_err, k5_err=k5_err,
                k3_ms=sum(k3_kernel) / 2, k3_plain_ms=sum(k3_plain) / 2,
                k5_ms=k5_ms, k5_plain_ms=sum(k5_plain) / 2,
                k3_bound=k3_bound, k5_bound=k5_bound)


def time_sweep_tiles(ct, tr, launch, kernel_name: str, tiles, tag: str) -> dict:
    """Time a sweep kernel, ``launch(tri, aabb, origin, ro, rd, t_min,
    t_max, stats=None)``, on each (label, ro, rd) tile of the table ``tr``:
    CUDA events over 10 calls, twice, and torch.profiler's device time
    per launch over 10 (device_ms), printed beside the needed (ray, cluster) pairs, the bound
    (sweep_bound), the share and the per-warp list lengths and sweeps.
    Returns {label: (events ms, device ms, bound)}."""
    import torch

    out = {}
    for label, ro, rd in tiles:
        args = (tr.sw_table, tr.sw_aabb, tr.sw_origin, ro, rd, 1e-3, float("inf"))
        stats = torch.zeros(3, dtype=torch.int32, device=ro.device)
        t, _, found = launch(*args, stats)
        pairs, tri_pairs = needed_work(ct, tr, ro, rd, t, found)
        bnd = sweep_bound(ro.shape[0], tr.v0.shape[0], tr.sw_aabb.shape[0], pairs, tri_pairs)
        ev = [cuda_ms(lambda: launch(*args), 10) for _ in range(2)]
        dev = device_ms(lambda: launch(*args), 10, kernel_name)
        share = (f"{bnd[0] / dev:.4f} (device)" if isinstance(dev, float)
                 else f"{bnd[0] / max(ev):.4f} (events)")
        print(f"[{tag}] {kernel_name} on {label} ({ro.shape[0]} rays, {int(found.sum())} on the "
              f"mesh): device {dev!r} ms, events {ev!r} ms; {pairs} needed (ray, cluster) pairs, "
              f"bound {bnd[0]!r} ms by {bnd[1]}, share {share}; "
              f"{sweep_stats(ct, stats, ro.shape[0], tr.sw_aabb.shape[0])}")
        out[label] = (sum(ev) / 2, dev, bnd)
    return out


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of ``flops`` over the float32 peak and ``nbytes`` over the memory rate."""
    f_ms, b_ms = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


def phase_a_bound(ci, tables, n: int):
    """bound() of one phase-A launch over ``n`` rays: rays (24 B) and a
    moving table's t_ray (4 B) in, winners (12 B) out, the tables once;
    per ray every sphere and rect test (a moving sphere's centre too) and
    one object ray per distinct transform of each transformed table, the
    least any implementation must do."""
    import torch

    def transforms(rows, tf):
        slot = rows[:, rows.shape[1] - ci.META_COLS].contiguous().view(torch.int32)
        return int(torch.unique(slot).numel()) if tf and rows.shape[0] else 0

    motion = tables.sph_motion
    per_ray = (tables.sph.shape[0] * (SPHERE_FLOPS + (MOTION_FLOPS if motion else 0))
               + tables.rect.shape[0] * RECT_FLOPS
               + TF_FLOPS * (transforms(tables.sph, tables.sph_tf)
                             + transforms(tables.rect, tables.rect_tf)))
    table_bytes = 4 * (tables.sph.numel() + tables.rect.numel() + tables.slots.numel())
    return bound(n * per_ray, n * (36 + (4 if motion else 0)) + table_bytes)


def time_k1(ci, tables, ro, rd):
    """K1 on one tile against its plain version: CUDA-event ms per call in
    turns (plain, kernel, kernel, plain) and torch.profiler device traces
    of 20 calls each.  Returns (kernel ms, plain ms, kernel device trace,
    plain device trace, bound); the launches do not count."""
    args = (tables, ro, rd, 1e-3, float("inf"))
    before = ci.LAUNCHES
    plain_ms = [cuda_ms(lambda: ci.phase_a_plain(*args), 50)]
    kernel_ms = [cuda_ms(lambda: ci.phase_a_cuda(*args), 200) for _ in range(2)]
    plain_ms.append(cuda_ms(lambda: ci.phase_a_plain(*args), 50))
    _, k_dev = profile_device(lambda: [ci.phase_a_cuda(*args) for _ in range(20)])
    _, p_dev = profile_device(lambda: [ci.phase_a_plain(*args) for _ in range(20)])
    ci.LAUNCHES = before
    return kernel_ms, plain_ms, k_dev, p_dev, phase_a_bound(ci, tables, ro.shape[0])


def launch_floor(cs, tag: str):
    """CUDA-event ms per launch (over 200) and torch.profiler device ms of
    an empty kernel launched through ctypes as the kernels are, printed:
    the floor under a kernel of a few microseconds."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    empty = cs._library().empty_launch
    ev = cuda_ms(lambda: empty(stream), 200)
    dev = device_ms(lambda: empty(stream), 20, "empty_kernel")
    print(f"[{tag}] empty kernel through ctypes (the launch floor): events {ev!r} ms, device "
          f"{dev!r} ms per launch")
    return ev, dev


def needed_work(ct, tr, ro, rd, t, found):
    """The work any front-to-back sweep over the table's 128-triangle
    clusters needs for these rays and their final winners (t, found):
    (needed (ray, cluster) pairs, ray-triangle tests of those pairs,
    counting only the real triangles of a short last cluster)."""
    import torch

    t_hit = torch.where(found, t, torch.full_like(t, float("inf")))
    counts = ct.needed_cluster_pairs(tr.sw_aabb, tr.sw_origin, ro, rd, 1e-3, t_hit)
    sizes = (tr.v0.shape[0] - torch.arange(counts.shape[0], device=counts.device) * ct.CL_CHUNK
             ).clamp(max=ct.CL_CHUNK)
    return int(counts.sum()), int((counts * sizes).sum())


def sweep_bound(n: int, n_tri: int, n_clusters: int, pairs: int, tri_pairs: int):
    """bound() of a triangle sweep over ``n`` rays, the same for K5 and
    K6: rays (24 B) in, winners (9 B) out, the (T, 16) table and the
    (Kc, 6) boxes once; a slab test per needed (ray, cluster) pair and a
    triangle test per triangle of it (needed_work)."""
    return bound(tri_pairs * TRI_FLOPS + pairs * SLAB_FLOPS,
                 n * 33 + 64 * n_tri + 24 * n_clusters)


def secondary_rays(tr, ro, rd, t, idx, found, n: int, seed: int):
    """``n`` secondary rays from the mesh hits of camera rays (ro, rd) with
    winners (t, idx, found): origins ro + rd t (the sweep's t_min offsets
    them), directions cosine-distributed (numpy, seeded) about the hit
    triangle's geometric normal turned back toward the incoming ray.  The
    hits go in ray order, repeated with fresh directions to fill ``n``
    rays, or evenly thinned when there are more."""
    pick = pick_hits(found, n)
    o = ro[pick] + rd[pick] * t[pick, None]
    return cosine_rays(o, tr.sw_n[idx[pick].long()].double(), rd[pick], seed)


def pick_hits(found, n: int):
    """The indices of ``n`` hit rays of ``found``, in ray order: repeated
    to fill ``n`` or evenly thinned when there are more."""
    import numpy as np
    import torch

    hits = torch.nonzero(found)[:, 0]
    return hits[torch.from_numpy(np.resize(np.arange(hits.shape[0]), n)).to(hits.device)
                if hits.shape[0] <= n else
                torch.linspace(0, hits.shape[0] - 1, n, device=hits.device).long()]


def cosine_rays(o, nrm, rd, seed: int):
    """Rays from origins ``o`` with directions cosine-distributed (numpy,
    seeded) about the normals ``nrm`` (float64) turned back toward the
    incoming directions ``rd``."""
    import numpy as np
    import torch

    n = o.shape[0]
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    nrm = torch.where(((nrm * rd.double()).sum(dim=1) > 0)[:, None], -nrm, nrm)
    r = np.random.RandomState(seed)
    u1, u2 = (torch.from_numpy(r.uniform(0.0, 1.0, n)).to(o.device) for _ in range(2))
    # an orthonormal basis (a, b, nrm) per ray
    helper = torch.where((nrm[:, 0].abs() > 0.9)[:, None],
                         torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64, device=o.device),
                         torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64, device=o.device))
    a = torch.linalg.cross(helper, nrm)
    a = a / a.norm(dim=1, keepdim=True)
    b = torch.linalg.cross(nrm, a)
    phi = 2.0 * np.pi * u2
    radius = torch.sqrt(u1)
    d = ((a * (radius * torch.cos(phi))[:, None] + b * (radius * torch.sin(phi))[:, None])
         + nrm * torch.sqrt(1.0 - u1)[:, None])
    d = d / d.norm(dim=1, keepdim=True)
    return o.contiguous(), d.float().contiguous()


def device_ms(fn, calls: int, kernel_name: str):
    """Device ms per launch of a kernel by torch.profiler, paired with a
    small PyTorch op (profile_pair)."""
    import torch

    x = torch.zeros(1 << 20, device="cuda")
    return profile_pair(fn, lambda: x.add_(1.0), calls, kernel_name)[0]


def kernel_share(pass_dev, kernel_name: str):
    """(device ms, launches, share of device busy) of the kernels whose
    name holds ``kernel_name`` in a profiled pass; None without a trace."""
    if not pass_dev:
        return None
    busy = sum(ms for _, ms in pass_dev.values())
    ms = sum(m for name, (_, m) in pass_dev.items() if kernel_name in name)
    calls = sum(c for name, (c, _) in pass_dev.items() if kernel_name in name)
    return ms, calls, ms / busy


def grid_rays(n: int, seed: int):
    """Rays from around C6's camera aimed at random points of the grid's
    box (numpy, seeded)."""
    import numpy as np
    import torch

    r = np.random.RandomState(seed)
    ro = np.array([-0.7, 0.8, 1.2]) + r.uniform(-0.2, 0.2, (n, 3))
    rd = r.uniform([-0.5, 0.03, -0.5], [0.5, 0.19, 0.5], (n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (torch.from_numpy(ro.astype(np.float32)).cuda(),
            torch.from_numpy(rd.astype(np.float32)).cuda())


def copies_rays(n: int, seed: int):
    """Rays from above the 27-bunny grid of scenes.bunny_copies, aimed down
    at it (numpy, seeded)."""
    import numpy as np
    import torch

    r = np.random.RandomState(seed)
    ro = r.uniform([-0.9, 0.6, -0.9], [0.9, 0.8, 0.9], (n, 3))
    rd = r.uniform([-0.9, 0.0, -0.9], [0.9, 0.15, 0.9], (n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (torch.from_numpy(ro.astype(np.float32)).cuda(),
            torch.from_numpy(rd.astype(np.float32)).cuda())


def compare_k6(ct, tr, ro, rd, what: str, dense: bool = False, tag: str = "15"):
    """K6 against cluster_sweep_plain (in 65,536-ray slices) on the same
    card tensors, and with ``dense`` against triangle_sweep_plain too;
    returns (largest |dt| over hits, (t, idx, found))."""
    import torch

    stats = torch.zeros(3, dtype=torch.int32, device=ro.device)
    before = ct.CL_LAUNCHES
    got = ct.cluster_sweep_cuda(tr.sw_table, tr.sw_aabb, tr.sw_origin, ro, rd, 1e-3,
                                float("inf"), stats)
    torch.cuda.synchronize()
    check(ct.CL_LAUNCHES == before + 1, "K6 launched")
    n, kc = ro.shape[0], tr.sw_aabb.shape[0]
    plain = [ct.cluster_sweep_plain(tr, ro[s:s + TILE], rd[s:s + TILE], 1e-3, float("inf"))
             for s in range(0, n, TILE)]
    err = agree(tag, f"K6 vs plain, {what} ({tr.v0.shape[0]} triangles, {kc} clusters of "
                f"{ct.CL_CHUNK})", n, got, [torch.cat(x) for x in zip(*plain)])
    if dense:
        plain = [ct.triangle_sweep_plain(tr.sw_table, tr.sw_origin, ro[s:s + TILE],
                                         rd[s:s + TILE], 1e-3, float("inf"))
                 for s in range(0, n, TILE)]
        err = max(err, agree(tag, f"K6 vs the dense plain version, {what}", n, got,
                             [torch.cat(x) for x in zip(*plain)]))
    pairs, _ = needed_work(ct, tr, ro, rd, got[0], got[2])
    print(f"[{tag}]   {pairs} of {n * kc} (ray, cluster) pairs needed ({pairs / (n * kc):.4f}); "
          f"{sweep_stats(ct, stats, n, kc)}")
    check(float(got[2].float().mean()) > 0.01, f"more than 1 % of the rays hit the mesh on {what}")
    return err, got


def compare_k4(ci, tables, ro, rd, t_ray, what: str) -> float:
    """K4 against phase_a_plain with the rays' shutter times (in 65,536-ray
    slices); returns the largest |dt| over hit rays."""
    before = ci.MOTION_LAUNCHES
    err, kind, idx = compare_phase_a(ci, tables, ro, rd, f"K4 vs plain, {what}", "17", t_ray)
    check(ci.MOTION_LAUNCHES == before + 1, "the moving sphere table launched K4")
    moving = int(((kind == 0) & (idx > 0)).sum())
    print(f"[17]   {moving} winners on the moving spheres")
    check(moving > 0, f"K4 winners include the moving spheres on {what}")
    return err


def check_images(images, size: int, mean_range, tag: str, name: str) -> None:
    """Finite, non-negative (size, size, 3) card images with a mean in
    ``mean_range``."""
    import torch

    for k, img in enumerate(images):
        mean = float(img.double().mean())
        print(f"[{tag}] pass {k}: mean {mean!r} max {float(img.max())!r}")
        check(img.shape == (size, size, 3) and img.device.type == "cuda",
              f"{name} pass {k} shape/device")
        check(bool(torch.isfinite(img).all()) and bool((img >= 0).all()),
              f"{name} pass {k} finite, >= 0")
        check(mean_range[0] < mean < mean_range[1], f"{name} pass {k} mean {mean} in {mean_range}")


def pass_timings(renderer, keys):
    """(ms per pass at each key, segments per second of one more pass),
    CUDA events, after the caller's warm-up."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    pass_ms = []
    for key in keys:
        start.record()
        renderer.render(key)
        end.record()
        torch.cuda.synchronize()
        pass_ms.append(start.elapsed_time(end))
    start.record()
    _, segments = renderer.render_with_stats(keys[-1] + 1)
    end.record()
    torch.cuda.synchronize()
    return pass_ms, segments, segments / (start.elapsed_time(end) / 1e3)


def bunny_grid_phases(smi: str) -> dict:
    """Phases 15, 16 and C6's part of 19 on the card: K6 against its plain
    version, the forward render of C6 (scenes.bunny_grid, the 79,488-
    triangle grid) at 512^2 and the Renderer's default depth, its checks
    and timings.  Returns the numbers the kernel record needs."""
    import torch
    from ray_tracing_tpu_torch import Renderer, RendererParam, scenes
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct
    from ray_tracing_tpu_torch.ops import intersect as pi
    from ray_tracing_tpu_torch.ops import rng

    dev = torch.device("cuda")
    host_scene, cam_param, param = scenes.bunny_grid()
    check((param.width, param.height, param.max_depth) == (C6_SIZE, C6_SIZE, None),
          "C6's own settings are 512^2 at the default depth")
    scene = host_scene.to(dev)
    check(pi.mesh_strategy(scene) == "cluster", "C6 takes the cluster sweep")
    tr = scene.triangles

    # 15. K6 against its plain version
    cam = Camera.build(cam_param, 1.0).to(dev)
    ro, rd, _, _ = camera_rays(cam, rng.key(0), C6_SIZE, C6_SIZE)
    ro, rd = ro.contiguous(), rd.contiguous()
    k6_err, cam_hit = compare_k6(ct, tr, ro, rd, f"{C6_SIZE}^2 C6 camera rays")
    # the main path's tile of camera rays with the most mesh hits (the
    # first tiles look at the sky), where K6 is timed below
    found = cam_hit[2]
    busiest = int(found.reshape(-1, TILE).sum(dim=1).argmax())
    tile = slice(busiest * TILE, (busiest + 1) * TILE)
    g_ro, g_rd = grid_rays(TILE, 0)
    k6_err = max(k6_err, compare_k6(ct, tr, g_ro, g_rd,
                                    f"{TILE} rays aimed at the grid (seed 0)")[0])
    # what C6's lambertian bunnies send on: secondary rays from the hits
    s_ro, s_rd = secondary_rays(tr, ro, rd, *cam_hit, TILE, 0)
    k6_err = max(k6_err, compare_k6(ct, tr, s_ro, s_rd, f"{TILE} secondary rays from the mesh "
                                    "hits (seed 0)", dense=True)[0])
    # K1 on C6's own table (its ground rect) at the shapes the C6 paths
    # give it: the camera rays and the secondary rays off the bunnies
    k1_err = compare_k1(ci, scene.phase_a, ro, rd, f"{C6_SIZE}^2 C6 camera rays", "15")
    k1_err = max(k1_err, compare_k1(ci, scene.phase_a, s_ro, s_rd,
                                    f"{TILE} C6 secondary rays (seed 0)", "15"))
    copies = scenes.bunny_copies(27).to(dev).triangles
    check(copies.sw_aabb.shape[0] > 1024, "27 copies pass 1024 clusters")
    c_ro, c_rd = copies_rays(TILE, 2)
    k6_err = max(k6_err, compare_k6(ct, copies, c_ro, c_rd,
                                    f"{TILE} rays on 27 bunnies (seed 2; K7's case)")[0])

    # 16. the main path
    renderer = Renderer(param, cam_param, host_scene, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    images = [renderer.render(k) for k in range(3)]
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"k1": ci.LAUNCHES, "k5": ct.LAUNCHES, "k6": ct.CL_LAUNCHES}
    print(f"[16] rendered 3 passes of C6 ({scene.n_triangles} triangles) at {C6_SIZE}^2 depth "
          f"{renderer.max_depth} (tile {renderer.tile_size}) in {main_s:.2f} s; K1 launches "
          f"{ci.LAUNCHES}, K5 launches {ct.LAUNCHES}, K6 launches {ct.CL_LAUNCHES}")
    check(ct.CL_LAUNCHES > 0 and ct.LAUNCHES == 0, "the C6 path launched K6 and not K5")
    check_images(images, C6_SIZE, C6_MEAN, "16", "C6")
    check(torch.equal(images[0], renderer.render(0)), "C6 render(0) twice is equal")
    print("[16] render(0) repeated: torch.equal")
    tiny = RendererParam(32, 32, max_depth=1)
    on_card = Renderer(tiny, cam_param, host_scene, device="cuda").render(0).cpu()
    on_cpu = Renderer(tiny, cam_param, host_scene, device="cpu").render(0)
    check(torch.equal(on_card, on_cpu), "C6 depth-1 image on the card equals the CPU render")
    print("[16] 32^2 depth 1: the card image equals the CPU render (torch.equal)")

    # 19. timings: the pass, and K6 on the busiest camera tile and the
    # secondary tile; the plain version on the secondary tile
    pass_ms, segments, seg_s = pass_timings(renderer, (10, 11))
    saved = (ci.LAUNCHES, ct.LAUNCHES, ct.CL_LAUNCHES)
    k6_args = (tr.sw_table, tr.sw_aabb, tr.sw_origin, s_ro, s_rd, 1e-3, float("inf"))
    plain = lambda: ct.cluster_sweep_plain(tr, s_ro, s_rd, 1e-3, float("inf"))
    k6_plain = [cuda_ms(plain, 2)]
    k6 = time_sweep_tiles(ct, tr, ct.cluster_sweep_cuda, "cluster_sweep_kernel", (
        (f"C6 camera-ray tile {busiest}", ro[tile].contiguous(), rd[tile].contiguous()),
        ("the C6 secondary tile", s_ro, s_rd)), "19")
    # K7's case: 1,048 clusters, more than one 512-cluster list page
    time_sweep_tiles(ct, copies, ct.cluster_sweep_cuda, "cluster_sweep_kernel",
                     (("the 27-bunny tile (K7's case)", c_ro, c_rd),), "19")
    k6_plain.append(cuda_ms(plain, 2))
    plain_dev = profile_pair(lambda: ct.cluster_sweep_cuda(*k6_args), plain, 2,
                             "cluster_sweep_kernel")[1]
    k1_ms, k1_plain, k1_dev, k1_pdev, k1_bound = time_k1(ci, scene.phase_a, s_ro, s_rd)
    small_renderer = Renderer(RendererParam(128, 128), cam_param, host_scene, device="cuda")
    small_renderer.render(30)
    pass_wall, pass_dev = profile_device(lambda: small_renderer.render(31))
    ci.LAUNCHES, ct.LAUNCHES, ct.CL_LAUNCHES = saved
    k6_ms, _, k6_bound = k6["the C6 secondary tile"]
    print(f"[19] card: {smi}")
    print(f"[19] ms per {C6_SIZE}^2 depth-{renderer.max_depth} C6 pass: {pass_ms!r}; "
          f"render_with_stats: {segments} segments, {seg_s!r} segments/s")
    print(f"[19] K6's plain version on the secondary tile: {k6_plain!r} ms by events (before and "
          f"after the kernel's timings), {plain_dev!r} ms device (torch.profiler)")
    print(f"[19] K1 on C6's table ({scene.phase_a.rect.shape[0]} rect, "
          f"{scene.phase_a.sph.shape[0]} spheres), the secondary tile: kernel {k1_ms!r} ms, plain "
          f"{k1_plain!r} ms (plain, kernel, kernel, plain); device per call kernel "
          f"{per_launch(k1_dev)!r} ms, plain "
          f"{sum(ms for _, ms in k1_pdev.values()) / 20 if k1_pdev else 'not measured'!r} ms; "
          f"bound {k1_bound[0]!r} ms by {k1_bound[1]}")
    busy_share(pass_dev, pass_wall, "19", f"128^2 depth-{small_renderer.max_depth} C6 pass")
    share = kernel_share(pass_dev, "cluster_sweep_kernel")
    if share:
        print(f"[19] K6 in that pass: {share[0]!r} ms in {share[1]} launches, {share[2]!r} of "
              f"device busy")
    return dict(launches=launches, k6_err=k6_err, k6_ms=k6_ms,
                k6_plain_ms=sum(k6_plain) / 2, k6_bound=k6_bound, k1_err=k1_err,
                k1_ms=sum(k1_ms) / 2, k1_plain_ms=sum(k1_plain) / 2, k1_bound=k1_bound)


def fwd_bwd_path(label: str, tag: str, scene, cam, size: int, depth: int, smi: str, *,
                 sj: bool) -> dict:
    """The full-parameter fwd+bwd of a scene with triangles at its own
    size and depth (grad_pass: 65,536-ray tiles under one key, one
    tangent pass; loss = image mean), driven with every count at 0 just
    before, its checks, a second pass at the same key, and its timings.
    ``sj`` marks scene.json: every leaf nonzero, K3 and K5 launched, the
    fog's albedo row live, the colors against a central difference.
    Otherwise (C6) K6 and not K5.  Returns the numbers the kernel record
    needs."""
    import torch
    from ray_tracing_tpu_torch.models.camera import camera_rays
    from ray_tracing_tpu_torch.models.scene import MAT_ISOTROPIC
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct
    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.render.prb_scalar import AllParams, _with_all, params_of

    n = size * size
    tiles = -(-n // TILE)
    key = rng.key(0)
    ro, rd, _, k_trace = camera_rays(cam, key, size, size, True)
    params = params_of(scene)
    mean_loss = lambda rad, rows: torch.sum(rad)
    reset_counts()
    t0 = time.perf_counter()
    loss, grads = grad_pass(params, scene, ro, rd, k_trace, mean_loss, depth)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1": ci.LAUNCHES, "k2": cs.LAUNCHES, "k3": ci.TF_LAUNCHES, "k5": ct.LAUNCHES,
                "k6": ct.CL_LAUNCHES}
    norms = {f: float(torch.linalg.vector_norm(getattr(grads, f))) for f in AllParams._fields}
    print(f"[{tag}] {label} {size}^2 depth {depth} fwd+bwd ({tiles} tiles of {TILE}, one tangent "
          f"pass): loss {float(loss)!r} in {wall:.2f} s; launches {launches}; gradient norms "
          f"{norms}")
    check(cs.LAUNCHES == tiles, f"{label}: K2 is called once per tile")
    if sj:
        check(ci.TF_LAUNCHES > 0 and ct.LAUNCHES > 0, "the scene.json fwd+bwd launched K3 and K5")
    else:
        check(ct.CL_LAUNCHES > 0 and ct.LAUNCHES == 0, "the C6 fwd+bwd launched K6 and not K5")
    for f in AllParams._fields:
        g = getattr(grads, f)
        check(g.shape == getattr(params, f).shape, f"{label} {f} gradient shape")
        check(bool(torch.isfinite(g).all()), f"{label} {f} gradient finite")
        check(norms[f] > 0.0 or not (sj or f == "color"), f"{label} {f} gradient nonzero")
    mean0 = image_mean(scene, cam, key, size, depth)
    print(f"[{tag}] image mean by render_pass {mean0!r}, loss {float(loss)!r}")
    check(abs(mean0 - float(loss)) <= 1e-5 * mean0, f"{label}: the loss is the image mean")
    if sj:
        mat = scene.materials
        fog = mat.tex[mat.mtype == MAT_ISOTROPIC].long()
        fog_row = grads.color[fog]
        print(f"[{tag}] the fog's isotropic albedo row {fog.tolist()}: {fog_row.tolist()}")
        check(bool((fog_row != 0).any()), "the fog's albedo gradient is nonzero")
        d = grads.color / torch.linalg.vector_norm(grads.color)
        eps = 1e-2
        at = lambda c: image_mean(_with_all(scene, params._replace(color=c)), cam, key, size,
                                  depth)
        fd = (at(params.color + eps * d) - at(params.color - eps * d)) / (2 * eps)
        gd = float((grads.color * d).sum())
        print(f"[{tag}] color gradient along g/|g|: g.d {gd!r}, central difference (eps {eps}) "
              f"{fd!r}, rel err {abs(fd - gd) / abs(gd)!r}")
        check(abs(fd - gd) <= 1e-2 * abs(gd),
              f"{label} color gradient matches the central difference, rtol 1e-2")

    # the second pass at the same key, timed
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    loss2, grads2 = grad_pass(params, scene, ro, rd, k_trace, mean_loss, depth)
    end.record()
    torch.cuda.synchronize()
    pass_ms = [start.elapsed_time(end)]
    equal = repeat_report(tag, loss, grads, loss2, grads2)
    for f in COLOR_LINEAR:
        check(equal[f], f"{label}: the {f} gradient (K2) repeats bit for bit")
    unequal = [f for f in ("fuzz", "ir") if not equal[f]]
    if unequal:  # hold them to the card's own noise floor between two keys
        _, other = grad_pass(params, scene, ro, rd, camera_rays(cam, rng.key(1), size, size,
                                                                  True)[3], mean_loss, depth)
        for f in unequal:
            a, b, c = (getattr(x, f) for x in (grads, grads2, other))
            matched, floor = float((a - b).abs().sum()), float((a - c).abs().sum())
            print(f"[{tag}] {f}: same-key difference {matched!r}, two-key difference {floor!r}")
            check(floor > 0 and matched <= 0.6 * floor, f"{label} {f} repeats inside the noise")

    # timings: segments counted untimed (bench.py:253-273), the split, K2,
    # one profiled tile
    segments = traced_segments(scene, ro, rd, k_trace, depth)
    saved = dict(launches)
    fwd_ms, sweep_ms, tangent_ms = split_pass(params, scene, ro, rd, k_trace, depth)
    rows, p_table = tile_segments(scene, ro, rd, k_trace, depth)
    k2_err = compare_k2(cs, p_table, rows, f"{label} tile 0 sweep, its stages in one call "
                        f"(table [gimg | gcol | gmet] of {p_table} rows)", tag)
    k2 = time_k2(cs, p_table, rows, dev=ro.device, tag=tag, scene_name=label)
    tile_wall, tile_dev = profile_device(
        lambda: grad_pass(params, scene, ro[:TILE], rd[:TILE], k_trace, mean_loss, depth))
    mean_ms = sum(pass_ms) / len(pass_ms)
    print(f"[{tag}] card: {smi}")
    print(f"[{tag}] ms per {label} {size}^2 depth-{depth} fwd+bwd pass: {pass_ms!r}; "
          f"{segments} traced segments (counted untimed, bench.py's unit): "
          f"{segments / (mean_ms / 1e3)!r} segments/s; {size}^2 rays/s {n / (mean_ms / 1e3)!r}")
    print(f"[{tag}] split of one pass: taped forward {fwd_ms!r} ms, sweep {sweep_ms!r} ms, "
          f"tangent pass {tangent_ms!r} ms")
    busy_share(tile_dev, tile_wall, tag, f"{label} fwd+bwd of one {TILE}-ray tile")
    return dict(launches=saved, k2_err=k2_err, k2_ms=k2["kernel"][0],
                k2_plain_ms=k2["plain"][0], k2_library_ms=k2["index_add_"][0],
                k2_bound=k2["bound"])


def grad_path_phases(smi: str) -> dict:
    """Phases 21 and 22: the full-parameter fwd+bwd of data/scene.json at
    800^2 depth SJ_GRAD_DEPTH (K2, K3, K5) and of C6 at 512^2 depth 20 (K2, K6), with
    their checks and timings."""
    import torch
    from ray_tracing_tpu_torch import load_scene_json, scenes
    from ray_tracing_tpu_torch.models.camera import Camera

    dev = torch.device("cuda")
    bundle = load_scene_json(os.path.join(ROOT, "data", "scene.json"))
    sj = fwd_bwd_path("scene.json", "21", bundle.scene.to(dev),
                      Camera.build(bundle.camera, 1.0).to(dev), SJ_SIZE, SJ_GRAD_DEPTH, smi,
                      sj=True)
    host_scene, cam_param, _ = scenes.bunny_grid()
    c6 = fwd_bwd_path("C6", "22", host_scene.to(dev), Camera.build(cam_param, 1.0).to(dev),
                      C6_SIZE, DEPTH, smi, sj=False)
    return {"sj": sj, "c6": c6}


def tie_scene(other: str):
    """A triangle in the plane z = -2 and, at the same t = 2 along -z from
    the origin, a rect in that plane or a sphere touching it (the scenes
    of tests/test_torch_prb_scene.py:test_kind_order_follows_the_tpu)."""
    from ray_tracing_tpu_torch import SceneBuilder

    b = SceneBuilder()
    m = [b.add_lambertian(b.add_texture_solid((0.1 * i, 0.5, 0.5))) for i in range(1, 3)]
    b.add_triangle([[-1.0, -1.0, -2.0], [3.0, -1.0, -2.0], [-1.0, 3.0, -2.0]], m[0])
    if other == "rect":
        b.add_rect("xy", -1, 1, -1, 1, -2.0, m[1], positive=True)
    else:
        b.add_sphere((0.0, 0.0, -3.0), 1.0, m[1])
    return b.build()


def kind_order_phase() -> None:
    """Phase 23: at an equal t the TPU's kind order decides on the card as
    on the CPU: a rect (K1) and a sphere (K1) win over a triangle (K5),
    which wins off them."""
    import torch
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct
    from ray_tracing_tpu_torch.ops.intersect import (
        KIND_RECT,
        KIND_SPHERE,
        KIND_TRIANGLE,
        intersect_scene,
    )

    dev = torch.device("cuda")
    ro = torch.tensor([[0.0, 0.0, 0.0], [0.25, -0.5, 0.0], [1.5, -0.5, 0.0]], device=dev)
    rd = torch.tensor([[0.0, 0.0, -1.0]] * 3, device=dev)
    saved = (ci.LAUNCHES, ct.LAUNCHES)
    for other, want in (("rect", KIND_RECT), ("sphere", KIND_SPHERE)):
        scene = tie_scene(other).to(dev)
        t_tri = ct.triangle_sweep(scene.triangles, ro, rd, 1e-3, float("inf"))[0]
        before = (ci.LAUNCHES, ct.LAUNCHES)
        hit = intersect_scene(scene, ro, rd, 1e-3, float("inf"))
        launched = (ci.LAUNCHES - before[0], ct.LAUNCHES - before[1])
        tied = [0, 1] if other == "rect" else [0]
        print(f"[23] {other} and triangle: triangle t {t_tri.tolist()}, winner t "
              f"{hit.t.tolist()}, kind {hit.kind.tolist()} (K1, K5 launches {launched})")
        check(launched == (1, 1), "the tie ran K1 and K5")
        check(t_tri.tolist() == [2.0] * 3 and all(float(hit.t[i]) == 2.0 for i in tied),
              f"{other} and triangle tie at t = 2")
        check(hit.kind[tied].tolist() == [want] * len(tied),
              f"the {other} wins the tie with the triangle on the card (the TPU's order)")
        check(int(hit.kind[2]) == KIND_TRIANGLE, "the triangle wins off the other primitive")
    ci.LAUNCHES, ct.LAUNCHES = saved


def busy_share(pass_dev, pass_wall: float, tag: str, what: str) -> None:
    """Print a profiled pass's device busy time, share of wall and top
    kernels, or that the profiler saw no device time."""
    if not pass_dev:
        print(f"[{tag}] torch.profiler saw no device time in the {what}: busy share not measured")
        return
    busy = sum(ms for _, ms in pass_dev.values())
    print(f"[{tag}] profiled {what}: wall {pass_wall!r} ms, device busy {busy!r} ms "
          f"({busy / pass_wall!r} of wall), {sum(n for n, _ in pass_dev.values())} device kernels")
    for name, (n, ms) in sorted(pass_dev.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"[{tag}]   {ms!r} ms in {n} launches: {name[:90]}")


def motion_phases(smi: str) -> dict:
    """Phases 17, 18 and the motion scene's part of 19 on the card: K4
    against its plain version, the forward render of
    examples/motion_blur.py (scenes.motion_blur) at 384^2 depth 8, its
    checks and timings.  Returns the numbers the kernel record needs."""
    import torch
    from ray_tracing_tpu_torch import Renderer, RendererParam, scenes
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import rng

    dev = torch.device("cuda")
    host_scene, cam_param, param = scenes.motion_blur()
    check((param.width, param.height, param.max_depth) == (MB_SIZE, MB_SIZE, MB_DEPTH),
          "the motion scene's own settings are 384^2 depth 8")
    scene = host_scene.to(dev)
    tables = scene.phase_a
    check(tables.sph_motion, "the sphere table moves")

    # 17. K4 against its plain version, the camera rays at their own times
    cam = Camera.build(cam_param, 1.0).to(dev)
    ro, rd, _, k_trace = camera_rays(cam, rng.key(0), MB_SIZE, MB_SIZE)
    n = MB_SIZE * MB_SIZE
    shutter = torch.stack([cam.time0, cam.time1])
    t_ray = rng.ray_time(k_trace, torch.arange(n, device=dev), shutter)
    k4_err = compare_k4(ci, tables, ro.contiguous(), rd.contiguous(), t_ray,
                        f"{MB_SIZE}^2 motion camera rays")
    m_ro, m_rd, m_t = motion_rays(TILE, 0)
    k4_err = max(k4_err, compare_k4(ci, tables, m_ro, m_rd, m_t,
                                    f"{TILE} random rays (seed 0) at seeded times"))

    # 18. the main path
    renderer = Renderer(param, cam_param, host_scene, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    images = [renderer.render(k) for k in range(3)]
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"k1": ci.LAUNCHES, "k4": ci.MOTION_LAUNCHES}
    print(f"[18] rendered 3 passes of the motion scene at {MB_SIZE}^2 depth {MB_DEPTH} (tile "
          f"{renderer.tile_size}) in {main_s:.2f} s; K1 launches {ci.LAUNCHES}, K3 launches "
          f"{ci.TF_LAUNCHES}, K4 launches {ci.MOTION_LAUNCHES}")
    check(ci.MOTION_LAUNCHES > 0 and ci.LAUNCHES == 0, "the motion path launched K4 and not K1")
    check_images(images, MB_SIZE, MB_MEAN, "18", "motion")
    check(torch.equal(images[0], renderer.render(0)), "motion render(0) twice is equal")
    print("[18] render(0) repeated: torch.equal")
    small = RendererParam(128, 128, max_depth=MB_DEPTH)
    small_renderer = Renderer(small, cam_param, host_scene, device="cuda")
    img_c, seg_c = small_renderer.render_with_stats(7)
    img_d, seg_d = dense_pass(small_renderer, 7)
    check(torch.equal(img_c, img_d) and seg_c == seg_d, "motion compacted equals dense")
    print(f"[18] 128^2 depth {MB_DEPTH}: compacted == dense (torch.equal), {seg_c} segments each")
    tiny = RendererParam(32, 32, max_depth=1)
    on_card = Renderer(tiny, cam_param, host_scene, device="cuda").render(0).cpu()
    on_cpu = Renderer(tiny, cam_param, host_scene, device="cpu").render(0)
    check(torch.equal(on_card, on_cpu), "motion depth-1 image on the card equals the CPU render")
    print("[18] 32^2 depth 1: the card image equals the CPU render (torch.equal)")

    # 19. timings: the pass, and K4 on the random tile
    pass_ms, segments, seg_s = pass_timings(renderer, (10, 11))
    saved = (ci.LAUNCHES, ci.TF_LAUNCHES, ci.MOTION_LAUNCHES)
    k4_args = (tables, m_ro, m_rd, 1e-3, float("inf"), m_t)
    k4_plain = [cuda_ms(lambda: ci.phase_a_plain(*k4_args), 20)]
    k4_kernel = [cuda_ms(lambda: ci.phase_a_cuda(*k4_args), 100) for _ in range(2)]
    k4_plain.append(cuda_ms(lambda: ci.phase_a_plain(*k4_args), 20))
    dev_ms = dict(zip(("k4", "k4_plain"), profile_pair(
        lambda: ci.phase_a_cuda(*k4_args), lambda: ci.phase_a_plain(*k4_args), 10,
        "phase_a_kernel")))
    small_renderer.render(30)
    pass_wall, pass_dev = profile_device(lambda: small_renderer.render(31))
    ci.LAUNCHES, ci.TF_LAUNCHES, ci.MOTION_LAUNCHES = saved
    k4_bound = phase_a_bound(ci, tables, TILE)
    launch_floor(cs, "19")
    print(f"[19] card: {smi}")
    print(f"[19] ms per {MB_SIZE}^2 depth-{MB_DEPTH} motion pass: {pass_ms!r}; "
          f"render_with_stats: {segments} segments, {seg_s!r} segments/s")
    print(f"[19] K4 on a {TILE}-ray tile: kernel {k4_kernel!r} ms, plain {k4_plain!r} ms (plain, "
          f"kernel, kernel, plain); device ms per call (torch.profiler) {dev_ms!r}; bound "
          f"{k4_bound[0]!r} ms by {k4_bound[1]}")
    busy_share(pass_dev, pass_wall, "19", f"128^2 depth-{MB_DEPTH} motion pass")
    return dict(launches=launches, k4_err=k4_err, k4_ms=sum(k4_kernel) / 2,
                k4_plain_ms=sum(k4_plain) / 2, k4_bound=k4_bound)


def large_tables(ci, kernel: str, n_sph: int, n_rect: int, seed: int):
    """Seeded phase-A tables in the 555 box: ``n_sph`` spheres (radius
    1-6; moving for "K4") and ``n_rect`` rects of 5-30 per side (for "K3"
    each under one of three transforms), in the kernels' layout."""
    import numpy as np
    import torch
    from ray_tracing_tpu_torch.ops import geometry as geo

    r = np.random.RandomState(seed)
    sph = np.concatenate([r.uniform(20, 535, (n_sph, 3)), r.uniform(1.0, 6.0, (n_sph, 1))], 1)
    if kernel == "K4":
        sph = np.concatenate([sph, r.uniform(-20, 20, (n_sph, 3))], 1)
    lo = r.uniform(40, 500, (n_rect, 2))
    bounds = np.stack([lo[:, 0], lo[:, 0] + r.uniform(5, 30, n_rect), lo[:, 1],
                       lo[:, 1] + r.uniform(5, 30, n_rect), r.uniform(40, 500, n_rect)], 1)
    rect = torch.cat([*geo.rect_basis(torch.from_numpy(r.randint(0, 3, n_rect))),
                      torch.from_numpy(bounds).float()], 1)
    if kernel == "K3":
        slots = []
        for th in (15.0, -40.0, 70.0):
            a = np.deg2rad(th)
            inv = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
            slots.append(np.concatenate([inv.ravel(), r.uniform(-30, 30, 3)]))
        rect = torch.cat([rect, torch.from_numpy(np.array(slots)[np.arange(n_rect) % 3]).float()],
                         1)
    return ci.pack_phase_a_tables(torch.from_numpy(sph).float().contiguous(), rect.contiguous())


def large_table_phase(ci) -> float:
    """Phase 20: K1, K3 and K4 against phase_a_plain on tables past the
    48 KB a block gets without opting in and past the 227 KB it may opt
    in to, on 8,192 rays from inside the box at seeded times.  Returns the
    largest |dt| (0.0)."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    ro, rd = interior_rays(8192, 3)
    t_ray = torch.from_numpy(np.random.RandomState(3).uniform(0, 1, 8192).astype(np.float32)).to(dev)
    err = 0.0
    for kernel, n_sph, n_rect in (("K1", 5000, 60), ("K1", 15_000, 60), ("K3", 30, 2500),
                                  ("K3", 30, 4000), ("K4", 5000, 60), ("K4", 15_000, 60)):
        tables = large_tables(ci, kernel, n_sph, n_rect, 7).to(dev)
        nbytes = 4 * (tables.sph.numel() + tables.rect.numel())
        counts = (ci.LAUNCHES, ci.TF_LAUNCHES, ci.MOTION_LAUNCHES)
        e, kind, _ = compare_phase_a(
            ci, tables, ro, rd, f"{kernel} vs plain, {n_sph} spheres and {n_rect} rects "
            f"({nbytes:,} B of tables{', 3 transforms' if kernel == 'K3' else ''})", "20", t_ray)
        which = {"K1": 0, "K3": 1, "K4": 2}[kernel]
        after = (ci.LAUNCHES, ci.TF_LAUNCHES, ci.MOTION_LAUNCHES)
        check(after[which] == counts[which] + 1, f"{kernel} launched on the large tables")
        check(int((kind == (2 if kernel == "K3" else 0)).sum()) > 100,
              f"{kernel} winners on the large table's {'rects' if kernel == 'K3' else 'spheres'}")
        err = max(err, e)
    return err


def read_png(path: str):
    """(H, W, 3) uint8 pixels of the PNG file at ``path`` (decode_png)."""
    with open(path, "rb") as fh:
        return decode_png(fh.read(), path)


def decode_png(data: bytes, what: str):
    """(H, W, 3) uint8 pixels of an 8-bit RGB PNG whose rows all use
    filter 0 (what utils/image.py writes), every chunk's CRC checked:
    the card's machine has no Pillow."""
    import struct
    import zlib

    import numpy as np

    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{what} starts with the PNG signature")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        check(zlib.crc32(kind + body) & 0xFFFFFFFF == crc, f"{what}: {kind} chunk CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    check(header is not None and header[2:] == (8, 2), f"{what} is 8-bit RGB")
    w, h = header[:2]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(bool((raw[:, 0] == 0).all()), f"{what}: every row has filter 0")
    return raw[:, 1:].reshape(h, w, 3)


def cli_phases(smi: str, tile_size: int) -> dict:
    """Phases 24 and 25 on the card: the port's CLI on data/zy_scene.json
    at 1024^2 depth CLI_DEPTH, in-process (a straight run and a resumed one,
    bit-equal) and as ``python -m`` (PNG with a profiler trace, HDR).
    ``tile_size`` is the renderer's at that size (phase 3).  The files go
    to a directory under build/ that is removed afterwards.  Returns the
    launches of the straight run."""
    import tempfile

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_cli_", dir=os.path.join(ROOT, "build")) as work:
        return _cli_phases(smi, tile_size, work)


def _cli_phases(smi: str, tile_size: int, work: str) -> dict:
    import contextlib
    import io

    import numpy as np
    import torch
    from ray_tracing_tpu_torch import Renderer, RendererParam, cli, load_scene_json
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct
    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.render.integrator import STAGE_BOUNCES
    from ray_tracing_tpu_torch.utils.checkpoint import load_render
    from ray_tracing_tpu_torch.utils.image import load_hdr

    zy = os.path.join(ROOT, "data", "zy_scene.json")
    # zy_scene.json's own renderer is 800^2; the CLI's flags set the
    # main path's 1024^2 at CLI_DEPTH
    common = ["-i", zy, "--width", str(SIZE), "--height", str(SIZE), "--max-depth",
              str(CLI_DEPTH), "--device", "cuda"]
    path = lambda name: os.path.join(work, name)

    def run(*argv) -> str:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            check(cli.main([*common, *argv]) == 0, f"cli.main({argv}) returns 0")
        print("".join(f"[24]   cli: {line}\n" for line in out.getvalue().splitlines()), end="")
        return out.getvalue()

    # the CLI's pass without the CLI: Renderer.render + the copy to the
    # host, by the host clock, once before and once after its runs
    bundle = load_scene_json(zy)
    renderer = Renderer(RendererParam(SIZE, SIZE, max_depth=CLI_DEPTH), bundle.camera,
                        bundle.scene, device="cuda")

    def host_pass(i: int) -> float:
        t0 = time.perf_counter()
        renderer.render(rng.fold_in(rng.key(0), i)).cpu()
        return time.perf_counter() - t0

    bare = [host_pass(0)]

    # 24. (a) four passes in one run, (b) two, then a resumed run to four
    reset_counts()
    t0 = time.perf_counter()
    log_a = run("-o", path("a.bmp"), "--iterations", "4", "--checkpoint", path("a.ckpt"),
                "--stats", path("a.json"))
    torch.cuda.synchronize()
    run_a_s = time.perf_counter() - t0
    launches = {"k1": ci.LAUNCHES, "k5": ct.LAUNCHES, "k6": ct.CL_LAUNCHES}
    reset_counts()
    run("-o", path("b.bmp"), "--iterations", "2", "--checkpoint", path("b.ckpt"))
    log_b = run("-o", path("b.bmp"), "--iterations", "4", "--checkpoint", path("b.ckpt"))
    launches_b = ci.LAUNCHES
    bare.append(host_pass(1))
    tiles = -(-SIZE * SIZE // tile_size)
    print(f"[24] CLI on zy {SIZE}^2 depth {CLI_DEPTH}: 4 passes in one run in {run_a_s:.2f} s; "
          f"K1 launches {launches['k1']} ({launches['k1'] / 4} per pass; {tiles} tiles x "
          f"{CLI_DEPTH} bounces = {tiles * CLI_DEPTH}), 2 + resumed 2: {launches_b}; K5 "
          f"{launches['k5']}, K6 {launches['k6']}")
    check(all(f"Iter {i} +" in log_a for i in range(1, 5)) and "Iter 4 saved" in log_a,
          "the straight run logs Iter 1-4 and saves")
    check("resumed at iteration 2" in log_b and "Iter 4 +" in log_b, "the second run resumes")
    check(launches["k1"] == launches_b, "the straight and the resumed runs launch K1 alike")
    check(4 * tiles * STAGE_BOUNCES <= launches["k1"] <= 4 * tiles * CLI_DEPTH,
          "K1 launched once per tile and bounce run, every tile through its first stage")
    check(launches["k5"] == launches["k6"] == 0, "zy launches no triangle sweep")
    (ra, seed_a), (rb, seed_b) = load_render(path("a.ckpt")), load_render(path("b.ckpt"))
    check(ra.count == rb.count == 4 and seed_a == seed_b == 0, "both checkpoints hold 4 passes")
    check(np.array_equal(ra.sum, rb.sum), "straight and resumed checkpoint sums equal")
    with open(path("a.bmp"), "rb") as fa, open(path("b.bmp"), "rb") as fb:
        bmp_a, bmp_b = fa.read(), fb.read()
    check(len(bmp_a) == 54 + SIZE * SIZE * 3 and bmp_a == bmp_b, "the two BMP files byte-equal")
    mean = float(ra.sum.astype(np.float64).mean() / 4)
    check(np.isfinite(ra.sum).all() and (ra.sum >= 0).all() and 0.1 < mean < 0.4,
          f"the CLI's 4-pass mean {mean} is finite, >= 0, in 0.1-0.4")
    with open(path("a.json")) as fh:
        stats = json.load(fh)
    per_pass = [(p["seconds"], p["segments"] / p["seconds"]) for p in stats["passes"]]
    print(f"[24] checkpoints: sums np.array_equal, BMPs byte-equal ({len(bmp_a)} bytes), "
          f"mean {mean!r}")
    print(f"[24] card: {smi}; --stats per pass (seconds, segments/s): {per_pass!r}; summary "
          f"{stats['summary']!r}; Renderer.render(...).cpu() by the host clock before and after "
          f"the CLI runs: {bare!r} s")

    # 25. the real entry point, as a user runs it
    def module(*argv):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ray_tracing_tpu_torch.cli", *common, *argv],
                              cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        print(f"[25] python -m ray_tracing_tpu_torch.cli {' '.join(argv)}: exit "
              f"{proc.returncode} in {wall:.1f} s; stdout {proc.stdout.strip()!r}")
        check(proc.returncode == 0, f"the CLI exits 0 ({proc.stderr[-2000:]})")
        check("Iter 1 +" in proc.stdout, "the CLI logs Iter 1")
        return wall

    prof = path("profile")
    png_s = module("-o", path("out.png"), "--iterations", "1", "--profile", prof)
    png = read_png(path("out.png"))
    check(png.shape == (SIZE, SIZE, 3) and int(png.max()) > 0, "the PNG decodes to 1024x1024")
    traces = [f for f in os.listdir(prof) if f.endswith(".json")]
    check(len(traces) == 1, "one Chrome trace written")
    t0 = time.perf_counter()
    with open(os.path.join(prof, traces[0])) as fh:
        events = json.load(fh)["traceEvents"]
    parse_s = time.perf_counter() - t0
    size_mb = os.path.getsize(os.path.join(prof, traces[0])) / 2**20
    kernels = [e for e in events if e.get("cat") == "kernel"]
    named = sum("phase_a_kernel" in e.get("name", "") for e in kernels)
    print(f"[25] PNG decodes to {png.shape}; trace {size_mb:.1f} MiB, {len(events)} events parsed "
          f"in {parse_s:.1f} s, {len(kernels)} device kernels, {named} of them phase_a_kernel "
          f"(K1; ctypes launches the profiler {'saw' if named else 'did not see'})")
    hdr_s = module("-o", path("out.hdr"), "--iterations", "1")
    hdr = load_hdr(path("out.hdr"))
    check(hdr.shape == (SIZE, SIZE, 3) and bool(np.isfinite(hdr).all())
          and bool((hdr >= 0).all()) and float(hdr.max()) > 0, "the HDR reads back finite, >= 0")
    print(f"[25] HDR reads back {hdr.shape}, mean {float(hdr.mean())!r}; wall {png_s:.1f} s (PNG, "
          f"profiled) and {hdr_s:.1f} s (HDR) per process")
    return dict(launches=launches)


def noise_phase(smi: str) -> dict:
    """Phase 26 on the card: Renderer.render_to_noise on C6 at 512^2 depth
    20 (checks at 8 and 16 passes), bit-equal to the mean of the same
    passes accumulated on the device.  Returns its launches."""
    import numpy as np
    import torch
    from ray_tracing_tpu_torch import Renderer, scenes
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct
    from ray_tracing_tpu_torch.ops import rng

    host_scene, cam_param, param = scenes.bunny_grid()
    renderer = Renderer(param, cam_param, host_scene, device="cuda")
    key = rng.key(0)
    renderer.render(rng.fold_in(key, 1000))  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    img, n, rel = renderer.render_to_noise(key, target_rel_err=NOISE_TARGET, min_passes=8,
                                           check_every=8, max_passes=16)
    noise_s = time.perf_counter() - t0
    launches = {"k1": ci.LAUNCHES, "k5": ct.LAUNCHES, "k6": ct.CL_LAUNCHES}
    t0 = time.perf_counter()
    acc = None
    for i in range(n):
        acc = renderer.accumulate(rng.fold_in(key, i), acc)
    want = acc.cpu().numpy() / n
    manual_s = time.perf_counter() - t0
    print(f"[26] render_to_noise on C6 {C6_SIZE}^2 depth {renderer.max_depth} (target "
          f"{NOISE_TARGET}, checks at 8 and 16): {n} passes, rel_err {rel!r}, {noise_s:.2f} s "
          f"({noise_s / n * 1e3:.1f} ms per pass); the same passes by accumulate {manual_s:.2f} s; "
          f"K6 launches {launches['k6']}, K1 {launches['k1']}, K5 {launches['k5']}; card: {smi}")
    check(img.dtype == np.float32 and img.shape == (C6_SIZE, C6_SIZE, 3), "image shape, dtype")
    check(bool(np.isfinite(img).all()) and bool((img >= 0).all()), "image finite, >= 0")
    check(np.array_equal(img, want), "render_to_noise equals the mean of the same passes")
    check(np.isfinite(rel) and rel > 0, f"rel_err {rel} finite and positive")
    check(launches["k6"] > 0 and launches["k5"] == 0, "render_to_noise on C6 launched K6")
    print(f"[26] image == sum of render(fold_in(key, i)), i < {n}, on the device / {n}: "
          f"np.array_equal; mean {float(img.astype(np.float64).mean())!r}")
    return dict(launches=launches, ms=noise_s / n * 1e3)


def gallery_phase(smi: str) -> dict:
    """Phase 27 on the card: one pass each of C3 (scenes.earth_sphere, K1)
    and C4 (scenes.bunny, K5) at 512^2 depth 20, finite, non-negative,
    deterministic and in range, each kernel held against its plain
    version on the scene's camera rays and timed on their busiest tile.
    Returns the numbers the kernel record needs."""
    import torch
    from ray_tracing_tpu_torch import Renderer, scenes
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct
    from ray_tracing_tpu_torch.ops import rng

    out = {}
    for name, build, mean_range in (("C3", scenes.earth_sphere, C3_MEAN),
                                    ("C4", scenes.bunny, C4_MEAN)):
        host_scene, cam_param, param = build()
        check((param.width, param.height, param.max_depth) == (GALLERY_SIZE, GALLERY_SIZE, None),
              f"{name}'s own settings are 512^2 at the default depth")
        scene = host_scene.to("cuda")
        cam = Camera.build(cam_param, 1.0).to("cuda")
        ro, rd, _, _ = camera_rays(cam, rng.key(0), GALLERY_SIZE, GALLERY_SIZE)
        ro, rd = ro.contiguous(), rd.contiguous()
        if name == "C3":
            err, kind, _ = compare_phase_a(ci, scene.phase_a, ro, rd,
                                           f"K1 vs plain, {GALLERY_SIZE}^2 C3 camera rays", "27")
            hits = kind >= 0
        else:
            tr = scene.triangles
            err, (_, _, hits) = compare_k5(ct, tr, ro, rd, f"{GALLERY_SIZE}^2 C4 camera rays", "27")
        busiest = int(hits.reshape(-1, TILE).sum(dim=1).argmax())
        t_ro = ro[busiest * TILE:(busiest + 1) * TILE].contiguous()
        t_rd = rd[busiest * TILE:(busiest + 1) * TILE].contiguous()

        renderer = Renderer(param, cam_param, host_scene, device="cuda")
        reset_counts()
        img = renderer.render(0)
        torch.cuda.synchronize()
        launches = {"k1": ci.LAUNCHES, "k5": ct.LAUNCHES, "k6": ct.CL_LAUNCHES}
        check_images([img], GALLERY_SIZE, mean_range, "27", name)
        check(torch.equal(img, renderer.render(0)), f"{name} render(0) twice is equal")
        pass_ms, segments, seg_s = pass_timings(renderer, (1, 2))
        print(f"[27] {name} {GALLERY_SIZE}^2 depth {renderer.max_depth} (tile "
              f"{renderer.tile_size}): launches {launches}; render(0) repeated: torch.equal; "
              f"ms per pass {pass_ms!r}; {segments} segments, {seg_s!r} segments/s; card: {smi}")
        saved = (ci.LAUNCHES, ct.LAUNCHES, ct.CL_LAUNCHES)
        if name == "C3":
            check(launches["k1"] > 0 and launches["k5"] == launches["k6"] == 0,
                  "the C3 pass launched K1 and no sweep")
            k_ms, p_ms, k_dev, p_dev, bnd = time_k1(ci, scene.phase_a, t_ro, t_rd)
            print(f"[27] K1 on C3's table ({scene.phase_a.rect.shape[0]} rects, "
                  f"{scene.phase_a.sph.shape[0]} sphere), camera tile {busiest}: kernel {k_ms!r} "
                  f"ms, plain {p_ms!r} ms (plain, kernel, kernel, plain); device per call kernel "
                  f"{per_launch(k_dev)!r} ms, plain "
                  f"{sum(ms for _, ms in p_dev.values()) / 20 if p_dev else 'not measured'!r} "
                  f"ms; bound {bnd[0]!r} ms by {bnd[1]}")
            out[name] = dict(launches=launches["k1"], err=err, ms=sum(k_ms) / 2,
                             plain_ms=sum(p_ms) / 2, bound=bnd, pass_ms=pass_ms)
        else:
            check(launches["k5"] > 0 and launches["k6"] == 0, "the C4 pass launched K5, not K6")
            plain = lambda: ct.triangle_sweep_plain(tr.sw_table, tr.sw_origin, t_ro, t_rd, 1e-3,
                                                    float("inf"))
            p_ms = [cuda_ms(plain, 3)]
            k5 = time_sweep_tiles(ct, tr, ct.triangle_sweep_cuda, "triangle_sweep_kernel",
                                  ((f"C4 camera-ray tile {busiest}", t_ro, t_rd),), "27")
            p_ms.append(cuda_ms(plain, 3))
            k_ms, _, bnd = next(iter(k5.values()))
            print(f"[27] K5's plain version on that tile: {p_ms!r} ms by events (before and after)")
            out[name] = dict(launches=launches["k5"], err=err, ms=k_ms, plain_ms=sum(p_ms) / 2,
                             bound=bnd, pass_ms=pass_ms)
        ci.LAUNCHES, ct.LAUNCHES, ct.CL_LAUNCHES = saved
    return out


# the learning rate of phase 28's SGD steps, from CPU runs of the same
# fit at 64^2 depth 20 (PERF.md): the loss fell over four steps at 0.05
# and 0.1 and rose at 0.2 and 0.5.  At 1024^2 depth 20 the fuzz and IR
# updates raised the loss (not at GRAD_DEPTH, PERF.md); phase 28's witness
# shows why
TRAIN_LR = 0.05


def elapsed_ms(fn):
    """(fn()'s result, its milliseconds between CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


@contextlib.contextmanager
def counted_sweeps():
    """Counts the tape sweep's scatter-adds (render/prb_tape.py:tape_sweep,
    one per tile) made inside, in a list of one int.  K2's wrapper makes
    one call of each, or more where it cuts the rows of a large tile past
    its blocks (ops/cuda_scatter.py:_calls)."""
    from ray_tracing_tpu_torch.render import prb_tape

    real, count = prb_tape.scatter_add, [0]

    def counting(table, segments):
        count[0] += 1
        return real(table, segments)

    prb_tape.scatter_add = counting
    try:
        yield count
    finally:
        prb_tape.scatter_add = real


def leaves_report(tag: str, what: str, got, want, rtol: float) -> None:
    """Check the color-linear leaves torch.equal and fuzz/IR within
    ``rtol``; print the largest difference of each leaf."""
    import torch
    from ray_tracing_tpu_torch.render.prb_scalar import AllParams

    diff = {f: float((getattr(got, f) - getattr(want, f)).abs().max()) if getattr(got, f).numel()
            else 0.0 for f in AllParams._fields}
    print(f"[{tag}] {what}: max |d| per leaf {diff}")
    for f in AllParams._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f in COLOR_LINEAR:
            check(torch.equal(a, b), f"{what}: the {f} leaf torch.equal")
        else:
            check(torch.allclose(a, b, rtol=rtol, atol=1e-8), f"{what}: {f} within rtol {rtol}")


# the witness of phase 28: fuzz and IR steps of 2e-6 and 1e-4 besides the
# SGD step's own; the largest relative difference at which a pixel's
# central difference counts as its derivative; the least share of the
# pixels with a nonzero derivative that must count so at one of the steps
WITNESS_STEPS = (2e-6, 1e-4)
WITNESS_RTOL = 0.1
WITNESS_PIXELS = 0.8


def scalar_witness(scene, ro, rd, k_trace, depth: int, fit, target, grads, lr: float) -> None:
    """Phase 28's independent witness of the fuzz and IR gradients: per
    pixel, the derivative of its loss term by forward AD of the same
    trace (trace_compacted under torch.autograd.forward_ad) against the
    central difference of the same term in renders at theta +- h, for h
    in WITNESS_STEPS and the SGD step's own lr |g|.  The loss is the
    step's, sum((rad - target)^2) / (3 n) at the step's key.

    Checks that the per-pixel derivatives add up to the step's gradient
    and that at least WITNESS_PIXELS of the pixels with a nonzero
    derivative meet their central difference within WITNESS_RTOL at one
    of the steps.  Prints, at each h, the central difference of the
    whole loss, the pixels that meet theirs and the share of sum |dL_i|
    they carry, the loss's rise on either side, and the ten largest
    terms beside their central differences; at the SGD step IR is also
    moved with the reflect/refract choice held at the unmoved IR (the
    Schlick reflectance fed the unmoved index), to show how much of the
    rise the choice makes.  The whole loss's central difference is not
    held to g: at a fixed key a moved fuzz or IR also flips paths, whose
    jumps no derivative sees."""
    import contextlib

    import torch
    import torch.autograd.forward_ad as fwAD
    from ray_tracing_tpu_torch.ops import sampling as smp
    from ray_tracing_tpu_torch.render.integrator import trace_compacted
    from ray_tracing_tpu_torch.render.prb_scalar import _active_rows, _with_all

    n = ro.shape[0]

    def render(p):
        s = _with_all(scene, p)
        return torch.cat([trace_compacted(s, ro[i:i + TILE], rd[i:i + TILE], k_trace, depth,
                                          ids_base=i) for i in range(0, n, TILE)]).double()

    def tangent(p):
        s = _with_all(scene, p)
        parts = []
        for i in range(0, n, TILE):
            t = fwAD.unpack_dual(trace_compacted(s, ro[i:i + TILE], rd[i:i + TILE], k_trace,
                                                 depth, ids_base=i)).tangent
            parts.append(torch.zeros_like(ro[i:i + TILE]) if t is None else t)
        return torch.cat(parts).double()

    @contextlib.contextmanager
    def choice_held(ir0: float):
        schlick = smp.schlick_reflectance
        smp.schlick_reflectance = lambda cosine, ratio: schlick(cosine, torch.full_like(ratio, ir0))
        try:
            yield
        finally:
            smp.schlick_reflectance = schlick

    t = target.reshape(n, 3).double()
    r0 = render(fit) - t
    l0 = (r0 * r0).sum(1)
    metal, glass = _active_rows(scene)
    for field, rows in (("fuzz", metal), ("ir", glass)):
        check(len(rows) == 1, f"zy has one {field} row")
        row = int(rows[0])
        base = getattr(fit, field)
        g = float(getattr(grads, field)[row])
        with fwAD.dual_level():
            unit = torch.zeros_like(base)
            unit[row] = 1.0
            jac = tangent(fit._replace(**{field: fwAD.make_dual(base, unit)}))
        dl = (2.0 * r0 * jac).sum(1) / (3 * n)  # each pixel's term of dL/dtheta
        g_sum = float(dl.sum())
        print(f"[28] {field}: step gradient {g!r}, per-pixel forward-AD derivatives summed "
              f"{g_sum!r}; {int((dl != 0).sum())} pixels with a nonzero term, the 10 largest "
              f"carry {float(dl.abs().topk(10).values.sum() / dl.abs().sum())!r} of sum |dL_i|")
        check(abs(g_sum - g) <= 1e-3 * abs(g) + 1e-9,
              f"the {field} gradient is the sum of the per-pixel derivatives (rtol 1e-3)")
        agreed = torch.zeros_like(dl, dtype=torch.bool)
        top = dl.abs().topk(10).indices
        step_h = lr * abs(g)
        for h in (*WITNESS_STEPS, step_h):
            variants = [("", contextlib.nullcontext)]
            if field == "ir" and h == step_h:
                variants.append((", reflect/refract choice held",
                                 lambda: choice_held(float(base[row]))))
            for label, ctx in variants:
                moved = []
                for sign in (1.0, -1.0):
                    p = base.clone()
                    p[row] = base[row] + sign * h
                    with ctx():
                        moved.append((((render(fit._replace(**{field: p})) - t) ** 2).sum(1),
                                      float(p[row] - base[row])))
                (lp, hp), (lm, hm) = moved
                hh = (hp - hm) / 2
                fd = (lp - lm) / (3 * n * 2 * hh)
                agree = (dl != 0) & ((fd - dl).abs() <= WITNESS_RTOL * dl.abs())
                if not label:
                    agreed |= agree
                share = float(dl[agree].abs().sum() / dl.abs().sum())
                rise = (float((lp - l0).sum()) / (3 * n), float((lm - l0).sum()) / (3 * n))
                print(f"[28] {field} +-{hh!r}{label}: central difference of the loss "
                      f"{float(fd.sum())!r} (g {g!r}); {int(agree.sum())} pixels within "
                      f"{WITNESS_RTOL} of their derivative, carrying {share!r} of sum |dL_i| and "
                      f"{float(dl[agree].sum())!r} of g (their central difference "
                      f"{float(fd[agree].sum())!r}); loss rise at +h {rise[0]!r}, at -h {rise[1]!r}"
                      + (f" (the SGD update is the {'-' if g > 0 else '+'}h side)" if h == step_h
                         else ""))
                if not label:
                    print(f"[28]   the ten largest terms {[f'{x:.3g}' for x in dl[top].tolist()]}, "
                          f"their central differences {[f'{x:.3g}' for x in fd[top].tolist()]}")
        live, met = int((dl != 0).sum()), int(agreed.sum())
        print(f"[28] {field}: {met} of {live} pixels meet their central difference within "
              f"{WITNESS_RTOL} at some h, carrying "
              f"{float(dl[agreed].abs().sum() / dl.abs().sum())!r} of sum |dL_i|")
        check(met >= WITNESS_PIXELS * live,
              f"at least {WITNESS_PIXELS} of the pixels with a nonzero {field} derivative meet "
              "their central difference")


def train_phases(smi: str, size: int = SIZE, depth: int = DEPTH, dev: str = "cuda") -> dict:
    """Phases 28-30: the train steps of parallel/mesh.py and the autograd
    surface on zy at ``size``^2 depth ``depth``, from perturbed wall
    colors toward a target rendered at the true parameters under the
    steps' own key.  Returns the numbers the kernel record needs."""
    import numpy as np
    import torch
    from ray_tracing_tpu_torch import load_scene_json
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.models.scene import MAT_DIFFUSE_LIGHT
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.parallel import distributed
    from ray_tracing_tpu_torch.parallel.mesh import (
        make_mesh,
        make_prb_train_step_all,
        make_prb_train_step_all_direct,
    )
    from ray_tracing_tpu_torch.render.prb_scalar import (
        AllParams,
        _with_all,
        params_of,
        prb_radiance_all,
        tiled_loss_and_grad,
    )
    from ray_tracing_tpu_torch.render.renderer import render_pass, tile_rule

    bundle = load_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))
    scene = bundle.scene.to(dev)
    cam = Camera.build(bundle.camera, 1.0).to(dev)
    n = size * size
    tile = tile_rule(n, dev)  # the step's own tile: on the card the whole image
    tiles = -(-n // tile)
    key = rng.key(0)
    true = params_of(scene)
    mat = scene.materials
    pinned = torch.zeros_like(true.color[:, :1], dtype=torch.bool)
    pinned[mat.tex[mat.mtype == MAT_DIFFUSE_LIGHT].long()] = True
    fit = true._replace(color=torch.where(pinned, true.color, 0.5))
    target = render_pass(scene, cam, key, width=size, height=size, max_depth=depth,
                         antialias=True, tile_size=TILE)
    kw = dict(width=size, height=size, max_depth=depth, lr=TRAIN_LR)

    # 28. the direct step, one process: step 1 on every leaf, held
    # against params - lr g by hand
    ro, rd, _, k_trace = camera_rays(cam, key, size, size, True)
    step = make_prb_train_step_all_direct(cam, scene, mesh=make_mesh(dev), **kw)
    reset_counts()
    with counted_sweeps() as sweeps:
        (first, loss1), step1_ms = elapsed_ms(lambda: step(fit, scene, key, target))
    launches = {"k1": ci.LAUNCHES, "k2": cs.LAUNCHES}
    segments = traced_segments(scene, ro, rd, k_trace, depth)
    print(f"[28] card: {smi}")
    print(f"[28] zy {size}^2 depth {depth} make_prb_train_step_all_direct, lr {TRAIN_LR}, every "
          f"leaf: step 1 loss {float(loss1)!r} in {step1_ms!r} ms (with its warm-up); "
          f"{segments} traced segments per step; launches {launches}; {tiles} tile(s) of "
          f"{tile}, {sweeps[0]} sweep scatter(s)")
    check(bool(torch.isfinite(loss1)), "the step's loss is finite")
    check(launches["k1"] > 0 and sweeps[0] == tiles and launches["k2"] >= tiles,
          "step 1 launched K1, and K2 for one sweep scatter per tile")
    t_flat = target.reshape(n, 3)
    _, direct = tiled_loss_and_grad(
        lambda r, rows: torch.sum((r - t_flat[rows]) ** 2) / (n * 3), fit, scene, ro, rd,
        k_trace, depth, tile_size=tile)
    by_hand = AllParams(*(p - TRAIN_LR * g for p, g in zip(fit, direct)))
    leaves_report("28", "step 1 against params - lr g by hand", first, by_hand, 1e-4)

    # what the step's update does to the loss at this key: the
    # color-linear leaves alone and every leaf (fuzz and IR alone: the
    # witness below, whose step h is the update's)
    def loss_at(p):
        img = render_pass(_with_all(scene, p), cam, key, width=size, height=size,
                          max_depth=depth, antialias=True, tile_size=TILE)
        return float(torch.mean((img - target) ** 2))

    moves = {"color-linear": COLOR_LINEAR, "every leaf": AllParams._fields}
    change = {name: loss_at(fit._replace(**{f: getattr(first, f) for f in fields}))
              - float(loss1) for name, fields in moves.items()}
    print(f"[28] loss change of step 1's update: {change}")
    scalar_witness(scene, ro, rd, k_trace, depth, fit, target, direct, TRAIN_LR)

    # three SGD steps of the color-linear leaves, fuzz and IR held (no
    # tangent pass), which must descend
    def color_step(p):
        loss, g = tiled_loss_and_grad(
            lambda rad, rows: torch.sum((rad - t_flat[rows]) ** 2) / (n * 3), p, scene, ro, rd,
            k_trace, depth, scalar_rows=((), ()))
        return AllParams(*(x - TRAIN_LR * gx for x, gx in zip(p, g))), loss

    reset_counts()
    params, losses, step_ms = fit, [], []
    with counted_sweeps() as sweeps:
        for _ in range(3):
            (params, loss), ms = elapsed_ms(lambda p=params: color_step(p))
            losses.append(float(loss))
            step_ms.append(ms)
    launches_c = {"k1": ci.LAUNCHES, "k2": cs.LAUNCHES}
    mean_ms = sum(step_ms) / len(step_ms)
    print(f"[28] three color-linear steps: losses {losses!r}; ms per step {step_ms!r}: "
          f"{segments / (mean_ms / 1e3)!r} segments/s; launches {launches_c}")
    check(all(np.isfinite(losses)), "every train-step loss is finite")
    check(losses[2] < losses[0], "the third step's loss is below the first's")
    check(sweeps[0] == 3 * tiles and launches_c["k2"] >= 3 * tiles,
          "K2 for one sweep scatter per tile in each step")
    check(torch.equal(params.fuzz, fit.fuzz) and torch.equal(params.ir, fit.ir),
          "scalar_rows=((), ()) holds fuzz and IR")

    # 29. the same step under a one-rank NCCL process group
    backend = "nccl" if dev == "cuda" else "gloo"
    with distributed.file_rendezvous(os.path.join(ROOT, "build")) as init:
        distributed.initialize(backend, init_method=init, world_size=1, rank=0)
        try:
            mesh = distributed.global_mesh(dev)
            check(mesh.collective and mesh.world == 1, "a one-rank process group")
            step_nccl = make_prb_train_step_all_direct(cam, scene, mesh=mesh, **kw)
            (p_nccl, l_nccl), ms_nccl = elapsed_ms(lambda: step_nccl(fit, scene, key, target))
            info = distributed.process_info()
        finally:
            torch.distributed.destroy_process_group()
    same = {f: bool(torch.equal(a, b)) for f, a, b in zip(AllParams._fields, p_nccl, first)}
    print(f"[29] {info}: one step in {ms_nccl!r} ms, loss {float(l_nccl)!r} (phase 28: "
          f"{float(loss1)!r}); parameters torch.equal to phase 28's first step per leaf {same}")
    check(float(l_nccl) == float(loss1) and all(same.values()),
          "the step under NCCL equals phase 28's first step")

    # 30. the autograd surface: forward, loss.backward(), against the
    # direct pass at the same key with the same loss
    leaves = AllParams(*(p.detach().requires_grad_(True) for p in fit))
    rad, fwd_ms = elapsed_ms(lambda: prb_radiance_all(leaves, scene, ro, rd, k_trace, depth))
    loss = torch.sum((rad - t_flat) ** 2) / (n * 3)
    _, bwd_ms = elapsed_ms(loss.backward)
    surface = AllParams(*(x.grad for x in leaves))
    print(f"[30] prb_radiance_all on zy {size}^2 depth {depth}: forward {fwd_ms!r} ms, "
          f"backward {bwd_ms!r} ms; loss {float(loss.detach())!r} (direct, summed by tile: "
          f"{float(loss1)!r})")
    check(abs(float(loss.detach()) - float(loss1)) <= 1e-5 * float(loss1),
          "the surface's loss equals the direct step's to rtol 1e-5")
    leaves_report("30", "loss.backward() against the direct pass", surface, direct, 1e-4)
    step_ad = make_prb_train_step_all(cam, scene, mesh=make_mesh(dev), **kw)
    (p_ad, l_ad), ad_ms = elapsed_ms(lambda: step_ad(fit, scene, key, target))
    diff = {f: float((a - b).abs().max()) for f, a, b in zip(AllParams._fields, p_ad, first)}
    print(f"[30] make_prb_train_step_all: one step {ad_ms!r} ms, loss {float(l_ad)!r}; max |d| "
          f"per leaf against phase 28's first step {diff}")
    check(abs(float(l_ad) - float(loss1)) <= 1e-6 * float(loss1)
          and all(torch.allclose(a, b, rtol=1e-4, atol=1e-8) for a, b in zip(p_ad, first)),
          "the autograd-surface step equals the direct step")
    return dict(launches=launches, step1_ms=step1_ms, step_ms=step_ms, fwd_ms=fwd_ms,
                bwd_ms=bwd_ms, ad_ms=ad_ms)


def examples_phase(smi: str, dev: str = "cuda") -> None:
    """Phase 31: the three fit examples on the card at reduced steps,
    in-process (their main), each reaching its final line:
    fit_geometry's error below its initial error, fit_materials' loss
    falling."""
    import contextlib
    import io
    import re

    from ray_tracing_tpu_torch.examples import fit_albedo, fit_geometry, fit_materials

    runs = (
        (fit_albedo, ["--steps", "10"], "final per-texture error"),
        (fit_materials, ["--steps", "12"], "final |fuzz err|"),
        # at its own 24^2 the fit first moves away (26 steps: 0.16 -> 0.26 in
        # both packages on the CPU); at 16^2 eight steps bring it closer
        (fit_geometry, ["--steps", "8", "--size", "16"], "final geometry error"),
    )
    for module, args, expect in runs:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = module.main([*args, "--device", dev])
        wall = time.perf_counter() - t0
        text = out.getvalue()
        name = module.__name__.rsplit(".", 1)[1]
        print(f"[31] {name} {' '.join(args)} on {dev}: {wall:.1f} s; card: {smi}")
        for line in text.strip().splitlines():
            print(f"[31]   {line}")
        check(expect in text, f"{name} printed its final line")
        if module is fit_geometry:
            check(result == 0, "fit_geometry's error fell below its initial error")
        if module is fit_materials:
            losses = [float(x) for x in re.findall(r"^step +\d+ loss ([0-9.]+)", text, re.M)]
            check(len(losses) >= 2 and losses[-1] < losses[0], "fit_materials' loss falls")


def weekend_generated():
    """generate(doc) of the weekend Document
    (ray_tracing_tpu_torch/examples/weekend_scene.py at WEEKEND_SEED) built
    with the port's editor, written to its project JSON and opened again:
    (scene, camera, renderer param)."""
    from ray_tracing_tpu_torch.editor import document_from_json, document_to_json, generate
    from ray_tracing_tpu_torch.examples.weekend_scene import build

    doc = document_from_json(json.loads(json.dumps(document_to_json(build(seed=WEEKEND_SEED)))))
    return generate(doc)


def sphere_secondary_rays(spheres, ro, rd, t, idx, found, n: int, seed: int):
    """``n`` secondary rays from the sphere hits of rays (ro, rd) with
    winners (t, idx, found): origins ro + rd t, directions
    cosine-distributed (numpy, seeded) about the hit sphere's normal."""
    pick = pick_hits(found, n)
    o = ro[pick] + rd[pick] * t[pick, None]
    nrm = o.double() - spheres.center[idx[pick].long()].double()
    return cosine_rays(o, nrm, rd[pick], seed)


def facade_pass(renderer):
    """One ``await renderer.render()`` of a v4ray.Renderer, timed with CUDA
    events; returns (numpy image, ms)."""
    import asyncio

    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    img = asyncio.run(renderer.render())  # the copy to the host waits for the pass
    end.record()
    torch.cuda.synchronize()
    return img, start.elapsed_time(end)


def weekend_phases(smi: str) -> dict:
    """Phases 32 and 33 on the card: the weekend scene through the port's
    editor and v4ray façade at 1200x800 depth 50, K1 on its 485-sphere,
    0-rect table against its plain version, then ProgressiveRenderController
    with two passes in flight on a cold build directory.  Returns the
    numbers the kernel record needs."""
    import asyncio
    import dataclasses
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    import ray_tracing_tpu_torch.v4ray as v4ray
    from ray_tracing_tpu_torch import Renderer, RendererParam
    from ray_tracing_tpu_torch.editor.render import ProgressiveRenderController
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import _build
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.render.renderer import tile_rule

    # 32. the document through the port's editor and its project JSON
    scene, camera, param = weekend_generated()
    w, h = WEEKEND_SIZE
    check((param.width, param.height, param.max_depth, param.antialias) == (w, h, 50, True)
          and camera.aperture == 0.1, "the weekend's final settings: 1200x800 depth 50, "
          "antialias, aperture 0.1")
    data = scene.compile()
    check((data.n_spheres, data.n_rects, data.n_lights) == (485, 0, 0),
          f"the weekend has 485 spheres, no rect, no light: {data.n_spheres}, "
          f"{data.n_rects}, {data.n_lights}")
    tables = data.to("cuda").phase_a
    check(tables.sph.shape[0] == 485 and tables.rect.shape[0] == 0
          and not (tables.transformed or tables.sph_motion), "K1's table: 485 spheres, 0 rects")

    # K1 against its plain version on a weekend tile: the camera rays and
    # secondary rays off their sphere hits
    cam = Camera.build(camera, w / h).to("cuda")
    ro, rd, _, _ = camera_rays(cam, rng.key(0), w, h)
    ro, rd = ro.contiguous(), rd.contiguous()
    err, kind, idx = compare_phase_a(ci, tables, ro, rd, f"K1 vs plain, {w}x{h} weekend camera "
                                     "rays (485 spheres, 0 rects)", "32")
    small = data.spheres.radius.to("cuda")[idx.clamp(min=0).long()] < 100.0
    on_small = (kind >= 0) & small
    n_tiles = ro.shape[0] // TILE
    busiest = int(on_small[:n_tiles * TILE].reshape(n_tiles, TILE).sum(dim=1).argmax())
    c_ro = ro[busiest * TILE:(busiest + 1) * TILE].contiguous()
    c_rd = rd[busiest * TILE:(busiest + 1) * TILE].contiguous()
    n_small = int(on_small[busiest * TILE:(busiest + 1) * TILE].sum())
    t, _, _ = ci.phase_a_plain(tables, c_ro, c_rd, 1e-3, float("inf"))
    _, c_kind, c_idx = compare_phase_a(ci, tables, c_ro, c_rd, f"K1 vs plain, weekend camera "
                                       f"tile {busiest} ({n_small} rays on the small spheres)",
                                       "32")
    s_ro, s_rd = sphere_secondary_rays(data.spheres.to("cuda"), c_ro, c_rd, t, c_idx,
                                       c_kind >= 0, TILE, 0)
    err = max(err, compare_phase_a(ci, tables, s_ro, s_rd, "K1 vs plain, 65536 secondary rays "
                                   "off the weekend tile's sphere hits", "32")[0])

    # the main path: generate -> v4ray.Renderer -> await render(), driven
    # with every count at 0 just before; one warm-up pass and two timed
    renderer = v4ray.Renderer(param, camera, scene, device="cuda")
    inner = renderer._inner
    card_tile = tile_rule(w * h, "cuda")
    check(inner.tile_size == card_tile == w * h,
          f"the card's renderer traces the whole image in one tile: {inner.tile_size}")
    reset_counts()
    t0 = time.perf_counter()
    images, pass_ms = zip(*[facade_pass(renderer) for _ in range(3)])
    main_s = time.perf_counter() - t0
    launches = ci.LAUNCHES
    print(f"[32] rendered 3 passes (iterations 1-3) of the weekend at {w}x{h} depth 50 through "
          f"v4ray.Renderer (tile {inner.tile_size}) in {main_s:.2f} s; K1 launches {launches} "
          f"({launches / 3!r} per pass), K3 {ci.TF_LAUNCHES}, K4 {ci.MOTION_LAUNCHES}")
    check(launches > 0 and ci.TF_LAUNCHES == ci.MOTION_LAUNCHES == 0,
          "the weekend path launched K1 and no other phase-A kernel")
    for k, img in enumerate(images):
        mean = float(img.astype(np.float64).mean())
        print(f"[32] iteration {k + 1}: mean {mean!r} max {float(img.max())!r}")
        check(img.shape == (h, w, 3) and img.dtype == np.float32, f"weekend pass {k} shape")
        check(bool(np.isfinite(img).all()) and bool((img >= 0).all()),
              f"weekend pass {k} finite, >= 0")
        check(WEEKEND_MEAN[0] < mean < WEEKEND_MEAN[1], f"weekend pass {k} mean {mean} in "
              f"{WEEKEND_MEAN}")
    # the iteration-3 key again at depth WEEKEND_TILE_DEPTH, with its
    # segments, at the card's tile and at the CPU rule's pick for 485
    # spheres: the same image and segments
    key3 = rng.fold_in(rng.key(0), 3)
    cpu_tile = tile_rule(w * h, "cpu", data.n_spheres + data.n_rects)
    print(f"[32] card: {smi}")
    print(f"[32] ms per {w}x{h} depth-50 pass at tile {card_tile} (CUDA events; the first is "
          f"the warm-up): {list(pass_ms)!r}")
    tile_param = dataclasses.replace(param, max_depth=WEEKEND_TILE_DEPTH)
    at_tile, first = {}, None
    for tile in (card_tile, cpu_tile):
        r = Renderer(tile_param, camera, data, device="cuda", tile_size=tile)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        again, segments = r.render_with_stats(key3)
        end.record()
        torch.cuda.synchronize()
        at_tile[tile] = (segments, start.elapsed_time(end))
        print(f"[32] render_with_stats at the iteration-3 key, depth {WEEKEND_TILE_DEPTH}, tile "
              f"{tile}: {segments} segments in {at_tile[tile][1]!r} ms = "
              f"{segments / (at_tile[tile][1] / 1e3)!r} segments/s")
        again = again.cpu().numpy()
        first = again if first is None else first
        check(np.array_equal(again, first), f"the iteration-3 key at depth {WEEKEND_TILE_DEPTH} "
              f"renders torch.equal at tiles {card_tile} and {tile}")
    check(at_tile[cpu_tile][0] == at_tile[card_tile][0], "the same segments at both tiles")

    # K1 timed on the busiest camera tile and the secondary tile, against
    # its plain version and its bound (operations: 65,536 x 485 sphere tests)
    timed = {}
    for label, t_ro, t_rd in ((f"camera tile {busiest}", c_ro, c_rd),
                              ("secondary tile", s_ro, s_rd)):
        k_ms, p_ms, k_dev, p_dev, bnd = time_k1(ci, tables, t_ro, t_rd)
        dev = per_launch(k_dev) if k_dev else "not measured"
        print(f"[32] K1 on the weekend {label}: kernel {k_ms!r} ms, plain {p_ms!r} ms (plain, "
              f"kernel, kernel, plain); device per call kernel {dev!r} ms, plain "
              f"{sum(ms for _, ms in p_dev.values()) / 20 if p_dev else 'not measured'!r} ms; "
              f"bound {bnd[0]!r} ms by {bnd[1]}")
        timed[label] = (sum(k_ms) / 2, sum(p_ms) / 2, bnd)

    # the device's busy share over a profiled pass of one tile (320x200 =
    # 64,000 rays) of the same document at depth 50
    one_tile = Renderer(RendererParam(320, 200, 50, True), camera, data, device="cuda")
    one_tile.render(0)
    pass_wall, pass_dev = profile_device(lambda: one_tile.render(1))
    busy_share(pass_dev, pass_wall, "32", "320x200 depth-50 weekend pass (one tile)")

    # 33. ProgressiveRenderController, two passes in flight on a second
    # façade renderer of the same scene (iterations 1-4), the kernels'
    # build directory empty and K1's library unloaded, so that two
    # executor threads make the first K1 launch together
    cold = Path(ROOT) / "build" / f"kernels_cold_{os.getpid()}"
    shutil.rmtree(cold, ignore_errors=True)
    cold.mkdir(parents=True)
    saved_dir = _build.BUILD_DIR
    _build.BUILD_DIR, ci._lib = cold, None
    compiles = _build.COMPILES
    passes, in_flight = 4, 2
    ctl_renderer = v4ray.Renderer(param, camera, scene, device="cuda")

    async def progressive():
        ctl = ProgressiveRenderController(ctl_renderer, w, h, in_flight=in_flight)
        # stop once the passes landed and those in flight make `passes`
        ctl.on_update = lambda img, n: ctl.stop() if n + in_flight - 1 >= passes else None
        ctl.start()
        while ctl._tasks:
            await ctl.drain()
        return ctl

    try:
        t0 = time.perf_counter()
        ctl = asyncio.run(progressive())
        ctl_s = time.perf_counter() - t0
        built = sorted(p.name for p in cold.iterdir())
    finally:
        _build.BUILD_DIR = saved_dir
    print(f"[33] ProgressiveRenderController (in_flight {in_flight}) on a cold build directory: "
          f"{ctl.result.count} passes in {ctl_s:.2f} s (the build included); nvcc runs "
          f"{_build.COMPILES - compiles}; the directory holds {built}")
    check(ctl.result.count == passes and ctl_renderer._iteration == passes,
          f"the controller folded exactly {passes} passes")
    check(_build.COMPILES == compiles + 1 and len(built) == 2
          and built[0].startswith("intersect_") and built[0].endswith(".log")
          and built[1].endswith(".so"), "one build of intersect.cu from two threads")
    fourth = inner.render(rng.fold_in(rng.key(0), 4)).cpu().numpy()
    want = np.zeros_like(fourth)
    for img in (*images, fourth):
        want += img
    want /= passes
    diff = float(np.abs(ctl.result.mean() - want).max())
    print(f"[33] the accumulated mean against iterations 1-4 rendered one after another: "
          f"max |d| = {diff!r}")
    check(bool(np.allclose(ctl.result.mean(), want, rtol=1e-6, atol=1e-7)),
          "the controller's mean equals the passes in turn (float32 summation order)")
    shutil.rmtree(cold, ignore_errors=True)
    cam_ms, cam_plain, cam_bound = timed[f"camera tile {busiest}"]
    return dict(launches=launches, err=err, ms=cam_ms, plain_ms=cam_plain, bound=cam_bound,
                pass_ms=list(pass_ms), at_tile=at_tile)


def web_phase(smi: str) -> dict:
    """Phase 34 on the card: serve(port=0, device="cuda") in a thread, the
    API driven over HTTP on localhost; K1, K4 and K5 launched by
    /api/render and held against their plain versions on the preview's
    rays.  Returns the numbers the kernel record needs."""
    import http.client
    import threading

    import numpy as np
    import torch

    import ray_tracing_tpu_torch.v4ray as v4ray
    from ray_tracing_tpu_torch.editor import document_from_json, generate
    from ray_tracing_tpu_torch.editor.web import serve
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct
    from ray_tracing_tpu_torch.ops import rng

    server = serve(port=0, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]

    def call(path, body=None, status=200):
        """One request; the response's status must be ``status``."""
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            if body is None:
                conn.request("GET", path)
            else:
                conn.request("POST", path, json.dumps(body),
                             {"Content-Type": "application/json"})
            resp = conn.getresponse()
            got, out = resp.status, json.loads(resp.read())
        finally:
            conn.close()
        check(got == status, f"{path}: status {got}, expected {status}: "
              f"{out.get('error') if isinstance(out, dict) else out}")
        return out

    def key_of(state, table, name):
        return next(k for k, v in state["document"][table].items() if v["name"] == name)

    def add(state, name, kind, values, mat):
        call("/api/edit", {"action": "add_object", "name": name})
        key = key_of(call("/api/state"), "objects", name)
        call("/api/edit", {"action": "set_shape", "key": key, "kind": kind, "values": values})
        state = call("/api/edit", {"action": "set_object", "key": key, "material": mat,
                                   "visible": True})
        check(key in state["analysis"]["rendered_objects"], f"{name} ({kind}) is rendered")
        return state, key

    def render(tag):
        """/api/render?passes=2 with every count at 0 just before: the
        decoded PNG equals the façade's render of generate(doc,
        preview=True) at the same two keys, tone-mapped as render_png does;
        returns (launches, the preview's scene, camera and param)."""
        reset_counts()
        t0 = time.perf_counter()
        out = call(f"/api/render?passes={WEB_PASSES}")
        wall = time.perf_counter() - t0
        launches = {"k1": ci.LAUNCHES, "k3": ci.TF_LAUNCHES, "k4": ci.MOTION_LAUNCHES,
                    "k5": ct.LAUNCHES, "k6": ct.CL_LAUNCHES}
        check(out["iterations"] == WEB_PASSES, f"{tag}: {WEB_PASSES} passes rendered")
        png = decode_png(base64.b64decode(out["png"]), f"/api/render ({tag})")
        doc = document_from_json(call("/api/project"))
        scene, camera, param = generate(doc, preview=True)
        facade = v4ray.Renderer(param, camera, scene, device="cuda")
        acc = np.zeros((param.height, param.width, 3), np.float32)
        for k in range(WEB_PASSES):
            acc += facade._inner.render(k).cpu().numpy()
        want = (np.sqrt(np.clip(acc / WEB_PASSES, 0.0, 1.0)) * 255).astype(np.uint8)
        print(f"[34] /api/render?passes={WEB_PASSES} ({tag}, {param.width}x{param.height} "
              f"preview) in {wall:.2f} s: launches {launches}; PNG equal to the façade's "
              f"render {np.array_equal(png, want)}, max |d| "
              f"{int(np.abs(png.astype(int) - want).max())}")
        check(np.array_equal(png, want), f"{tag}: the PNG equals the façade's render")
        return launches, (scene, camera, param)

    def preview_rays(camera, param):
        cam = Camera.build(camera, param.width / param.height).to("cuda")
        ro, rd, _, k_trace = camera_rays(cam, rng.key(0), param.width, param.height,
                                         antialias=False)
        n = param.width * param.height
        t_ray = rng.ray_time(k_trace, torch.arange(n, device="cuda"),
                             torch.stack([cam.time0, cam.time1]))
        return ro.contiguous(), rd.contiguous(), t_ray

    try:
        state = call("/api/state")
        regs = call("/api/registries")
        check(state["analysis"]["camera_valid"] and {"sphere", "moving-sphere", "mesh"}
              <= regs["shapes"].keys(), "the editor serves its state and registries")
        mat = key_of(state, "materials", "gray mat")
        # a close camera on the origin, shutter [0, 1]; the default sphere,
        # which would hold the bunny, moves back; then a sphere is added
        call("/api/edit", {"action": "set_camera", "kind": "perspective", "values": [
            0.0, 0.14, 0.55, 0.0, 0.09, 0.0, 35.0, 0.0, 1.0, 0.0, 0.0, 0.5, 0.0, 1.0]})
        call("/api/edit", {"action": "set_shape", "key": key_of(state, "objects", "sphere"),
                           "kind": "sphere", "values": [-0.6, 0.5, -1.5, 0.5]})
        state, _ = add(state, "ball", "sphere", [0.16, 0.05, 0.02, 0.05], mat)
        k1_launches, (scene1, camera1, param1) = render("three spheres")
        check(k1_launches["k1"] > 0 and k1_launches["k4"] == k1_launches["k5"] == 0,
              "the spheres' preview launched K1")
        state, _ = add(state, "mover", "moving-sphere",
                       [-0.17, 0.05, 0.03, -0.11, 0.05, 0.03, 0.04, 0.0, 1.0], mat)
        state, bunny = add(state, "bunny", "mesh", [os.path.join(ROOT, "data", "bunny.obj"), ""],
                           mat)
        launches, (scene2, camera2, param2) = render("spheres, a moving sphere and the bunny")
        check(launches["k4"] > 0 and launches["k5"] > 0 and launches["k1"] == 0
              and launches["k6"] == 0, "the preview launched K4 (the moving sphere's table) and "
              "K5 (the bunny), not K1 or K6")

        # the kernels against their plain versions on the preview's rays
        tables1 = scene1.compile().to("cuda").phase_a
        ro1, rd1, _ = preview_rays(camera1, param1)
        k1_err = compare_k1(ci, tables1, ro1, rd1, f"{param1.width}x{param1.height} preview "
                            "rays, three spheres", "34")
        data2 = scene2.compile().to("cuda")
        tables2 = data2.phase_a
        check(tables2.sph_motion and data2.n_triangles == 4968, "a moving table and the bunny")
        ro2, rd2, t_ray2 = preview_rays(camera2, param2)
        before = ci.MOTION_LAUNCHES
        k4_err, kind, idx = compare_phase_a(ci, tables2, ro2, rd2, f"K4 vs plain, "
                                            f"{param2.width}x{param2.height} preview rays at "
                                            "their shutter times", "34", t_ray2)
        check(ci.MOTION_LAUNCHES == before + 1, "the moving table launched K4")
        moving = torch.nonzero(data2.spheres.vel.abs().sum(dim=1) > 0)[:, 0].to(idx.dtype)
        on_mover = int(((kind == 0) & torch.isin(idx, moving)).sum())
        print(f"[34]   {on_mover} winners on the moving sphere")
        check(on_mover > 0, "K4 winners include the moving sphere")
        tr = data2.triangles
        k5_err, _ = compare_k5(ct, tr, ro2, rd2, f"{param2.width}x{param2.height} preview rays",
                               "34")

        # timings at these shapes, after their launches above
        saved = (ci.LAUNCHES, ci.TF_LAUNCHES, ci.MOTION_LAUNCHES, ct.LAUNCHES, ct.CL_LAUNCHES)
        k1_ms, k1_plain, _, _, k1_bound = time_k1(ci, tables1, ro1, rd1)
        k4_args = (tables2, ro2, rd2, 1e-3, float("inf"), t_ray2)
        k4_plain = [cuda_ms(lambda: ci.phase_a_plain(*k4_args), 20)]
        k4_ms = [cuda_ms(lambda: ci.phase_a_cuda(*k4_args), 100) for _ in range(2)]
        k4_plain.append(cuda_ms(lambda: ci.phase_a_plain(*k4_args), 20))
        k4_bound = phase_a_bound(ci, tables2, ro2.shape[0])
        k5_plain = lambda: ct.triangle_sweep_plain(tr.sw_table, tr.sw_origin, ro2, rd2, 1e-3,
                                                   float("inf"))
        k5_p = [cuda_ms(k5_plain, 3)]
        k5 = time_sweep_tiles(ct, tr, ct.triangle_sweep_cuda, "triangle_sweep_kernel",
                              ((f"{param2.width}x{param2.height} preview rays", ro2, rd2),), "34")
        k5_p.append(cuda_ms(k5_plain, 3))
        k5_ms, _, k5_bound = next(iter(k5.values()))
        (ci.LAUNCHES, ci.TF_LAUNCHES, ci.MOTION_LAUNCHES, ct.LAUNCHES, ct.CL_LAUNCHES) = saved
        print(f"[34] card: {smi}")
        print(f"[34] K1 on the preview rays: kernel {k1_ms!r} ms, plain {k1_plain!r} ms; bound "
              f"{k1_bound[0]!r} ms by {k1_bound[1]}")
        print(f"[34] K4 on the preview rays: kernel {k4_ms!r} ms, plain {k4_plain!r} ms; bound "
              f"{k4_bound[0]!r} ms by {k4_bound[1]}")
        print(f"[34] K5's plain version on the preview rays: {k5_p!r} ms (before and after)")

        # undo follows; errors come back as JSON bodies and the server goes on
        state = call("/api/undo", {})
        check(bunny not in state["analysis"]["rendered_objects"] and state["can_redo"],
              "undo took the bunny's material and visibility back")
        state = call("/api/redo", {})
        check(bunny in state["analysis"]["rendered_objects"], "redo restored it")
        bad = call("/api/edit", {"action": "explode"}, status=500)
        check("unknown action" in bad["error"], "an unknown action is a JSON error")
        bad = call("/api/edit", {"action": "set_shape", "key": "nope", "kind": "sphere",
                                 "values": [0, 0, 0, 1]}, status=500)
        check("error" in bad, "a malformed key is a JSON error")
        project = call("/api/project")
        state = call("/api/edit", {"action": "load_project", "project": project})
        check(state["document"]["objects"].keys() == project["objects"].keys()
              and state["can_undo"], "the project round trip through load_project")
        print("[34] undo and redo followed; two invalid edits came back as JSON errors (500) and "
              "the server went on; the project round trip loaded")
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    return dict(k1=k1_launches["k1"], k4=launches["k4"], k5=launches["k5"],
                k1_err=k1_err, k4_err=k4_err, k5_err=k5_err,
                k1_ms=sum(k1_ms) / 2, k1_plain_ms=sum(k1_plain) / 2, k1_bound=k1_bound,
                k4_ms=sum(k4_ms) / 2, k4_plain_ms=sum(k4_plain) / 2, k4_bound=k4_bound,
                k5_ms=k5_ms, k5_plain_ms=sum(k5_p) / 2, k5_bound=k5_bound)


def path_kernels(kernels, scene, ro, rd, what: str, tag: str, t_ray=None) -> dict:
    """Each kernel of ``kernels`` (of "k1", "k3", "k4", "k5", "k6") held
    against its plain version on a path's own card rays (compare_phase_a,
    compare_k5, compare_k6: winners equal, t bit-equal) and timed there by
    CUDA events in turns (plain, kernel, kernel, plain), beside its bound
    from these rays (phase_a_bound, sweep_bound).  The launches made here
    do not count: every count is put back.  Returns {kernel: dict(err,
    ms, plain_ms, bound)}."""
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct

    saved = (ci.LAUNCHES, ci.TF_LAUNCHES, ci.MOTION_LAUNCHES, ct.LAUNCHES, ct.CL_LAUNCHES)
    ro, rd, inf = ro.contiguous(), rd.contiguous(), float("inf")
    tr, out = scene.triangles, {}
    for k in kernels:
        if k in ("k1", "k3", "k4"):
            args = (scene.phase_a, ro, rd, 1e-3, inf, t_ray)
            err = compare_phase_a(ci, scene.phase_a, ro, rd, f"{k.upper()} vs plain, {what}", tag,
                                  t_ray)[0]
            kernel = lambda: ci.phase_a_cuda(*args)
            plain = lambda: ci.phase_a_plain(*args)
            bnd, reps = phase_a_bound(ci, scene.phase_a, ro.shape[0]), (100, 20)
        else:
            args = (tr.sw_table, tr.sw_aabb, tr.sw_origin, ro, rd, 1e-3, inf)
            if k == "k5":
                err, (t, _, found) = compare_k5(ct, tr, ro, rd, what, tag)
                kernel = lambda: ct.triangle_sweep_cuda(*args)
                plain = lambda: ct.triangle_sweep_plain(tr.sw_table, tr.sw_origin, ro, rd, 1e-3,
                                                        inf)
            else:
                err, (t, _, found) = compare_k6(ct, tr, ro, rd, what, tag=tag)
                kernel = lambda: ct.cluster_sweep_cuda(*args)
                plain = lambda: ct.cluster_sweep_plain(tr, ro, rd, 1e-3, inf)
            pairs, tri_pairs = needed_work(ct, tr, ro, rd, t, found)
            bnd = sweep_bound(ro.shape[0], tr.v0.shape[0], tr.sw_aabb.shape[0], pairs, tri_pairs)
            reps = (20, 3)
        p_ms = [cuda_ms(plain, reps[1])]
        k_ms = [cuda_ms(kernel, reps[0]) for _ in range(2)]
        p_ms.append(cuda_ms(plain, reps[1]))
        print(f"[{tag}] {k.upper()} on {what} ({ro.shape[0]} rays): kernel {k_ms!r} ms, plain "
              f"{p_ms!r} ms (plain, kernel, kernel, plain); bound {bnd[0]!r} ms by {bnd[1]}")
        out[k] = dict(err=err, ms=sum(k_ms) / 2, plain_ms=sum(p_ms) / 2, bound=bnd)
    ci.LAUNCHES, ci.TF_LAUNCHES, ci.MOTION_LAUNCHES, ct.LAUNCHES, ct.CL_LAUNCHES = saved
    return out


def host_compile_split() -> dict:
    """Seconds of C6's host compile (scenes.bunny_grid: 79,488
    triangles) and of its parts on the same arrays: the OBJ load, the
    Morton order, the sweep constants, the CUDA sweeps' tables, the
    cluster tables and phase A's tables.  The first build is the one
    render_baselines makes; this is a second, in the same process.  The
    Morton order is timed over the table's own boxes (the authored
    vertices' are not kept, and differ by an ulp at most)."""
    import numpy as np
    import torch

    from ray_tracing_tpu_torch import scenes
    from ray_tracing_tpu_torch.models import compiler, scene as sc
    from ray_tracing_tpu_torch.models.mesh import load_triangles

    out = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        out[name] = time.perf_counter() - t0
        return res

    built = timed("bunny_grid()", scenes.bunny_grid)[0]
    timed("load_triangles(bunny.obj)", load_triangles, os.path.join(scenes.DATA, "bunny.obj"))
    tr = built.triangles
    verts = torch.stack([tr.v0, tr.v0 + tr.e12, tr.v0 + tr.e13], dim=1).numpy()
    timed("morton_order", compiler.morton_order, verts.min(axis=1), verts.max(axis=1))
    bare = sc.TriangleTable(**{f: getattr(tr, f) for f in (
        "v0", "e12", "e13", "n0", "n1", "n2", "uv0", "uv1", "uv2", "material")})
    swept = timed("pack_triangle_sweep", sc.pack_triangle_sweep, bare)
    swept = timed("pack_sweep_kernel_tables", sc.pack_sweep_kernel_tables, swept)
    timed("pack_triangle_clusters", sc.pack_triangle_clusters, swept)
    timed("with_phase_a_tables", sc.with_phase_a_tables, built)
    check(np.array_equal(swept.sw_table.numpy(), tr.sw_table.numpy()),
          "C6's sweep tables packed again equal the compiler's")
    return out


def baselines_phase(smi: str) -> dict:
    """Phase 35 on the card: render_baselines.main in-process at
    GALLERY_ARGS, one configuration a call into one directory (stats.json
    merges them), with every count at 0 just before each: six configs in
    stats.json with the JAX script's keys, each PNG decoding to its size,
    each mean in GALLERY_MEAN, the launches of K1, K3, K4, K5 and K6 per
    config; each configuration's kernels held against their plain
    versions on its first pass's camera rays and timed there
    (path_kernels); then C6's host compile apart from its passes.
    Returns the launches, stats, those kernels' numbers and the compile
    seconds."""
    import tempfile

    import torch
    from ray_tracing_tpu_torch.examples import render_baselines
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct
    from ray_tracing_tpu_torch.ops import rng

    launches, wall = {}, {}
    with tempfile.TemporaryDirectory() as work:
        for name in render_baselines.CONFIGS:
            reset_counts()
            t0 = time.perf_counter()
            render_baselines.main(["--out", work, "--configs", name, *GALLERY_ARGS,
                                   "--device", "cuda"])
            torch.cuda.synchronize()
            wall[name] = time.perf_counter() - t0
            launches[name] = {"k1": ci.LAUNCHES, "k3": ci.TF_LAUNCHES, "k4": ci.MOTION_LAUNCHES,
                              "k5": ct.LAUNCHES, "k6": ct.CL_LAUNCHES}
        with open(os.path.join(work, "stats.json")) as fh:
            stats = json.load(fh)
        check(sorted(stats) == sorted(GALLERY_RUNS), "stats.json holds the six configurations")
        for name, (size, spp) in GALLERY_RUNS.items():
            rec = stats[name]
            check(tuple(rec) == ("size", "spp", "seconds_per_pass", "total_seconds",
                                 "mean_radiance", "image"), f"{name}: the JAX script's keys")
            check((rec["size"], rec["spp"]) == (size, spp), f"{name} at {size}^2, {spp} spp")
            png = read_png(rec["image"])
            check(png.shape == (size, size, 3), f"{name}'s PNG decodes to {size}x{size}")
            lo, hi = GALLERY_MEAN[name]
            check(lo < rec["mean_radiance"] < hi,
                  f"{name} mean {rec['mean_radiance']} in {GALLERY_MEAN[name]}")
            print(f"[35] {name} {size}^2 x {spp} spp: {rec['seconds_per_pass']!r} s/pass (after "
                  f"the first), {rec['total_seconds']!r} s, mean {rec['mean_radiance']!r}, "
                  f"main() wall {wall[name]!r} s with the build; launches {launches[name]}; "
                  f"card: {smi}")
    want = {"C1": ("k3", "k5"), "C2": ("k1",), "C3": ("k1",), "C4": ("k1", "k5"),
            "C5": ("k1",), "C6": ("k1", "k6")}
    for name, kernels in want.items():
        got = {k for k, v in launches[name].items() if v}
        check(got == set(kernels), f"{name} launched {sorted(kernels)} and no other ({got})")
    rows = {}
    for name, kernels in want.items():
        scene, cam_param, _, _ = render_baselines.build(name)
        size = GALLERY_RUNS[name][0]
        cam = Camera.build(cam_param, 1.0).to("cuda")
        ro, rd, _, _ = camera_rays(cam, rng.fold_in(rng.key(0), 0), size, size)
        rows[name] = path_kernels(kernels, scene.to("cuda"), ro, rd,
                                  f"{name}'s {size}^2 first-pass camera rays", "35")
    split = host_compile_split()
    c6_pass = stats["C6"]["seconds_per_pass"]
    print(f"[35] C6 host compile (79,488 triangles), s: {split}; against {c6_pass!r} s per "
          f"{GALLERY_RUNS['C6'][0]}^2 pass")
    return {"launches": launches, "stats": stats, "rows": rows, "compile": split}


def motion_demo_phase(smi: str) -> dict:
    """Phase 36 on the card: motion_blur.main at MB_DEMO (depth 8), every
    count at 0 just before: the PNG decodes to its size, the mean is in
    MB_MEAN, K4 launched and K1 not; K4 held against its plain version on
    the first pass's camera rays at their shutter times and timed there."""
    import tempfile

    from ray_tracing_tpu_torch import scenes
    from ray_tracing_tpu_torch.examples import motion_blur
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import rng

    with tempfile.TemporaryDirectory() as work:
        out = os.path.join(work, "motion_blur.png")
        reset_counts()
        t0 = time.perf_counter()
        mean = motion_blur.main(["--out", out, *MB_DEMO, "--device", "cuda"])
        wall = time.perf_counter() - t0
        launches = {"k1": ci.LAUNCHES, "k4": ci.MOTION_LAUNCHES}
        size = int(MB_DEMO[1])
        check(read_png(out).shape == (size, size, 3), f"the demo's PNG decodes to {size}^2")
    print(f"[36] motion demo {size}^2 x {MB_DEMO[3]} spp depth 8: mean {mean!r}, {wall!r} s with "
          f"the build; launches {launches}; card: {smi}")
    check(MB_MEAN[0] < mean < MB_MEAN[1], f"the demo's mean {mean} in {MB_MEAN}")
    check(launches["k4"] > 0 and launches["k1"] == 0, "the demo launched K4 and not K1")
    scene, cam_param, _ = scenes.motion_blur()
    cam = Camera.build(cam_param, 1.0).to("cuda")
    ro, rd, t_ray, _ = camera_rays(cam, rng.fold_in(rng.key(0), 0), size, size)
    rows = path_kernels(("k4",), scene.to("cuda"), ro, rd,
                        f"the demo's {size}^2 first-pass camera rays", "36", t_ray.contiguous())
    return {"launches": launches, "mean": mean, "rows": rows}


def walk_t_slack(tr, ro, rd, idx):
    """How far the walk's t (Moeller-Trumbore: (e13 . ((ro - v0) x e12))
    / det) and K5's (the triple products: (o . n - d0) / -(rd . n)) may
    part beyond rtol: a few float32 ulps of each numerator's terms, which
    cancel, over |det| = |rd . n| (large on a grazing hit or near the
    ray's origin, where t is small), in float64."""
    import numpy as np

    i = idx.long()
    n = tr.sw_n[i].double()
    det = (rd.double() * n).sum(dim=1).abs()
    sweep = ((ro.double() - tr.sw_origin.double()).norm(dim=1) * n.norm(dim=1)
             + tr.sw_d0[i].double().abs())
    walk = ((ro.double() - tr.v0[i].double()).norm(dim=1) * tr.e12[i].double().norm(dim=1)
            * tr.e13[i].double().norm(dim=1))
    return 4 * float(np.finfo(np.float32).eps) * (sweep + walk) / det


def walk_against_k5(bvh, ct, tr, tree, ro, rd, what: str) -> dict:
    """The BVH walk against K5 on the same rays: found equal; t within
    rtol 1e-5 widened per ray by walk_t_slack (the walk uses
    Moeller-Trumbore, K5 the triple products); idx equal but at t ties,
    where the walk's winner's t is within that bound of K5's (a shared
    edge, which the two arithmetics break apart), counted.  Returns K5's
    result, the ties, the walk's steps and its ms by events."""
    import torch

    inf = float("inf")
    kt, kidx, kfound = ct.triangle_sweep_cuda(tr.sw_table, tr.sw_aabb, tr.sw_origin, ro, rd,
                                              1e-3, inf)
    steps = bvh.STEPS
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    hit = bvh.bvh_traverse_triangles(tree, ro, rd, 1e-3, inf)
    end.record()
    torch.cuda.synchronize()
    steps = bvh.STEPS - steps
    ms = start.elapsed_time(end)
    both = hit.mask & kfound
    dt = (hit.t[both].double() - kt[both].double()).abs()
    allowed = 1e-5 * kt[both].double() + walk_t_slack(tr, ro[both], rd[both], kidx[both])
    widened = int((dt > 1e-5 * kt[both].double()).sum())
    ties = int((hit.index[both] != kidx[both]).sum())
    print(f"[37] walk vs K5, {what}: {ro.shape[0]} rays, {int(kfound.sum())} on the mesh; found "
          f"mismatches {int((hit.mask != kfound).sum())}, idx apart at {ties} t ties, t past "
          f"rtol 1e-5 on {widened} rays (inside their slack), max |dt| / allowed "
          f"{float((dt / allowed).max()) if dt.numel() else 0.0!r}; walk {ms!r} ms in {steps} "
          f"steps ({steps + 1} host reads)")
    check(torch.equal(hit.mask, kfound), f"{what}: the walk finds what K5 finds")
    check(bool((dt <= allowed).all()), f"{what}: t within rtol 1e-5 and its slack, so idx "
          "equal but at t ties")
    return {"k5": (kt, kidx, kfound), "ties": ties, "steps": steps, "ms": ms}


def bvh_phase(smi: str) -> dict:
    """Phase 37 on the card: the BVH walk (ops/bvh.py, plain PyTorch) on
    C4's bunny (scenes.bunny(bvh=True)): against K5 on the busiest
    65,536-ray camera tile and 65,536 secondary rays off its hits; a
    WALK_SIZE^2 depth-1 pass through the walk torch.equal to the sweep's;
    depth-20 passes at tiles WALK_TILES torch.equal to each other, finite,
    with a mean in C4_MEAN, timed, with the walk's calls and steps and
    the launches of each pass (K1 and no sweep through the walk, K5 in
    the sweep's pass); K1 and K5 held against their plain versions on
    those passes' camera rays (path_kernels)."""
    import torch
    from ray_tracing_tpu_torch import Renderer, RendererParam, scenes
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import bvh, rng
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct
    from ray_tracing_tpu_torch.ops.intersect import mesh_strategy

    t0 = time.perf_counter()
    host, cam_param, _ = scenes.bunny()
    t1 = time.perf_counter()
    walked_host = scenes.bunny(bvh=True)[0]
    t2 = time.perf_counter()
    check(mesh_strategy(walked_host) == "bvh", "C4 built with its BVH takes the walk")
    scene, walked = host.to("cuda"), walked_host.to("cuda")
    tr, tree = scene.triangles, walked.bvh
    print(f"[37] C4's BVH: {tree.n_nodes} nodes over {host.n_triangles} triangles; C4 compiled "
          f"in {t1 - t0!r} s, with its BVH (bvh=True) in {t2 - t1!r} s")
    cam = Camera.build(cam_param, 1.0).to("cuda")
    ro, rd, _, _ = camera_rays(cam, rng.key(0), GALLERY_SIZE, GALLERY_SIZE)
    _, _, found = ct.triangle_sweep_cuda(tr.sw_table, tr.sw_aabb, tr.sw_origin, ro.contiguous(),
                                         rd.contiguous(), 1e-3, float("inf"))
    busiest = int(found.reshape(-1, TILE).sum(dim=1).argmax())
    t_ro = ro[busiest * TILE:(busiest + 1) * TILE].contiguous()
    t_rd = rd[busiest * TILE:(busiest + 1) * TILE].contiguous()
    cam_run = walk_against_k5(bvh, ct, tr, tree, t_ro, t_rd, f"C4 camera tile {busiest}")
    s_ro, s_rd = secondary_rays(tr, t_ro, t_rd, *cam_run["k5"], TILE, 37)
    sec_run = walk_against_k5(bvh, ct, tr, tree, s_ro, s_rd, "secondary tile")
    walk_ms = [walk_against_k5(bvh, ct, tr, tree, t_ro, t_rd, "camera tile, again")["ms"]]

    one = RendererParam(WALK_SIZE, WALK_SIZE, max_depth=1)
    got = Renderer(one, cam_param, walked_host, device="cuda").render(0)
    want = Renderer(one, cam_param, host, device="cuda").render(0)
    check(torch.equal(got, want), f"{WALK_SIZE}^2 depth 1: the walk's pass equals the sweep's")
    deep = RendererParam(WALK_SIZE, WALK_SIZE)
    passes, launches = {}, {}
    for tile in WALK_TILES:
        r = Renderer(deep, cam_param, walked_host, device="cuda", tile_size=tile)
        walks, steps = bvh.WALKS, bvh.STEPS
        reset_counts()
        img, pass_ms = elapsed_ms(lambda: r.render(0))
        launches[tile] = {"k1": ci.LAUNCHES, "k5": ct.LAUNCHES, "k6": ct.CL_LAUNCHES}
        passes[tile] = (img, pass_ms, bvh.WALKS - walks, bvh.STEPS - steps)
        check(launches[tile]["k1"] > 0 and launches[tile]["k5"] == launches[tile]["k6"] == 0,
              f"the walk's pass at tile {tile} launched K1 and no sweep")
    check_images([passes[t][0] for t in WALK_TILES], WALK_SIZE, C4_MEAN, "37", "C4 via the walk")
    check(torch.equal(passes[WALK_TILES[0]][0], passes[WALK_TILES[1]][0]),
          "the walk's depth-20 pass does not depend on the tile")
    sweeper = Renderer(deep, cam_param, host, device="cuda")
    walks = bvh.WALKS
    reset_counts()
    sweep_img, sweep_ms = elapsed_ms(lambda: sweeper.render(0))
    launches["sweep"] = {"k1": ci.LAUNCHES, "k5": ct.LAUNCHES, "k6": ct.CL_LAUNCHES}
    check(launches["sweep"]["k5"] > 0 and bvh.WALKS == walks, "the sweep's pass launched K5 "
          "and walked no BVH")
    for tile, (_, ms, walks, steps) in passes.items():
        print(f"[37] {WALK_SIZE}^2 depth 20 through the walk at tile {tile}: {ms!r} ms, {walks} "
              f"walks, {steps} steps ({steps + walks} host reads); launches {launches[tile]}; "
              f"card: {smi}")
    print(f"[37] the same pass through K5: {sweep_ms!r} ms, mean {float(sweep_img.mean())!r}; "
          f"launches {launches['sweep']}; images torch.equal at depth 1")
    cam128 = Camera.build(cam_param, 1.0).to("cuda")
    ro, rd, _, _ = camera_rays(cam128, rng.key(0), WALK_SIZE, WALK_SIZE)
    rows = path_kernels(("k1", "k5"), scene, ro, rd,
                        f"C4's {WALK_SIZE}^2 camera rays of render(0)", "37")
    return {"camera": cam_run, "secondary": sec_run, "walk_ms": walk_ms,
            "passes": {t: v[1:] for t, v in passes.items()}, "launches": launches,
            "rows": rows}


SCALING_KEYS = ("metric", "value", "unit", "per_device", "devices", "segments_per_pass",
                "primary_rays_per_pass", "unsharded_same_work_s", "sharded_s",
                "sharding_overhead")


def scaling_phase(smi: str) -> dict:
    """Phase 38 on the card: ``python bench_scaling_torch.py --devices 1``
    (one NCCL rank, 16,384 zy rays, depth 10, 3 passes) as a subprocess:
    its line carries every key of bench_scaling.py's, sharding_overhead
    finite, the one rank's loss and color gradient equal to the unsharded
    run's (the same computation), the segments equal."""
    import numpy as np

    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, os.path.join(ROOT, "bench_scaling_torch.py"),
                          "--devices", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    check(run.returncode == 0, f"bench_scaling_torch.py exited {run.returncode}: "
          f"{run.stderr[-2000:]}")
    lines = [json.loads(x) for x in run.stdout.splitlines() if x.startswith("{")]
    check(len(lines) == 1, "one JSON line for one rank")
    rec = lines[0]
    missing = [k for k in SCALING_KEYS if k not in rec]
    check(not missing, f"the line carries bench_scaling.py's keys (missing {missing})")
    check(bool(np.isfinite(rec["sharding_overhead"])), "sharding_overhead is finite")
    check(rec["segments_per_pass"] == rec["unsharded_segments_per_pass"],
          "one rank counts the unsharded segments")
    np.testing.assert_allclose(rec["color_grad"], rec["unsharded_color_grad"], rtol=1e-6)
    print(f"[38] bench_scaling_torch.py --devices 1 ({wall!r} s with the start): "
          f"{json.dumps({k: rec[k] for k in SCALING_KEYS})}; backend {rec['backend']}; rank 0's "
          f"launches in the timed passes {rec['launches']}; card: {smi}")
    check(rec["launches"]["k1"] > 0 and rec["launches"]["k2"] > 0,
          "the harness's timed passes launched K1 and K2")
    return dict(rec, **harness_kernels())


def harness_kernels() -> dict:
    """K1 and K2 of bench_scaling_torch.py on its rank-0 rays (16,384 zy
    camera rays, depth 10) in this process: K1 held against its plain
    version and timed (path_kernels); K2 on the rows of one fwd+bwd of
    those rays under the first timed pass's key, caught at the sweep's
    scatter (render/prb_tape.py), against scatter_add_plain on the CPU
    (compare_k2) and timed beside its plain version and index_add_
    (time_k2).  Returns {"k1": ..., "k2_err": ..., "k2": ...}."""
    import torch

    import bench_scaling_torch as harness
    from ray_tracing_tpu_torch import load_scene_json
    from ray_tracing_tpu_torch.models.camera import Camera
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.render import prb_tape

    bundle = load_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))
    scene = bundle.scene.to("cuda")
    per = 16384
    ro, rd = harness._rays(Camera.build(bundle.camera, 1.0).to("cuda"), per, 0)
    rows = path_kernels(("k1",), scene, ro, rd, f"the harness's rank-0 rays ({per} zy)", "38")
    calls, real = [], prb_tape.scatter_add

    def catch(table, segments):
        calls.append((table.shape[0], [tuple(x.clone() for x in seg) for seg in segments]))
        return real(table, segments)

    prb_tape.scatter_add = catch
    try:
        harness._fwd_bwd(scene, ro, rd, rng.key(1), 10, 0, per)
    finally:
        prb_tape.scatter_add = real
    check(len(calls) == 1, f"one K2 call for the harness's {per}-ray tile ({len(calls)})")
    p, segments = calls[0]
    before = cs.LAUNCHES
    err = compare_k2(cs, p, segments, f"the harness's rank-0 tile ({per} zy rays, depth 10)",
                     "38")
    k2 = time_k2(cs, p, segments, torch.device("cuda"), "38", "harness")
    cs.LAUNCHES = before
    return {"k1": rows["k1"], "k2_err": err, "k2": k2}


BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "mode", "spread")  # bench.py's record
BENCH_SPREAD = ("blocks", "passes_per_block", "min", "max")
BENCH_METRIC = "zy_scene 1024^2 fwd+bwd rays/s/chip"
# the seven offset bunnies of phase 41 (scenes.bunny_copies(7): 34,776
# triangles, above SWEEP_MAX_TRIS) with their cluster tables dropped, seen
# from in front and above, rendered at TAIL_SIZE^2 depth TAIL_DEPTH
TAIL_COPIES, TAIL_SIZE, TAIL_DEPTH = 7, 256, 3
BRUTE_SIZE = 128  # the depth-1 render of C4's bunny through the brute-force grid
BRUTE_RTOL = 1e-5  # Moeller-Trumbore's t against K5's (tests/test_torch_triangles.py)


def bench_phase(smi: str) -> dict:
    """Phase 39 on the card: bench_torch.main(passes=1, reps=1) at the
    bench's own 1024^2 and depth 20, driven with every count at 0 just
    before: the record has exactly bench.py's keys and a finite positive
    value; its segments equal traced_segments at the same key; its loss
    and five gradient leaves equal grad_pass (tiled_loss_and_grad) at the
    same key, torch.equal; K1 launched and K2 called once per tile of
    each pass.  Then K1 and K2 held against their plain versions on the
    bench's own tensors (tile 0 of key 1: its camera rays, its sweep rows
    at depth 20) and timed there.  Returns the numbers the kernel record
    needs."""
    import math

    import torch

    import bench_torch
    from ray_tracing_tpu_torch import load_scene_json
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.render.prb_scalar import AllParams, params_of

    details = {}
    reset_counts()
    t0 = time.perf_counter()
    rec = bench_torch.main(passes=1, reps=1, details=details)
    wall = time.perf_counter() - t0
    launches = {"k1": ci.LAUNCHES, "k2": cs.LAUNCHES}
    print(f"[39] bench_torch.main(passes=1, reps=1) in {wall!r} s (count, warm-up, one timed "
          f"pass): {json.dumps(rec)}; launches {launches}; block CUDA-event ms "
          f"{details['block_event_ms']!r}; max_memory_allocated "
          f"{details['max_memory_allocated']}; card: {smi}")
    check(tuple(rec) == BENCH_KEYS and tuple(rec["spread"]) == BENCH_SPREAD,
          f"the record has exactly bench.py's keys ({list(rec)})")
    check(rec["metric"] == BENCH_METRIC and rec["unit"] == "rays/s" and rec["mode"] == "prb",
          "the record names bench.py's metric, unit and mode")
    check(math.isfinite(rec["value"]) and rec["value"] > 0, "the bench's value is finite, > 0")
    check(details["depth"] == DEPTH and details["tile"] == TILE, "the bench ran at depth 20, "
          "tiles of 65,536")
    n_tiles = SIZE * SIZE // TILE
    check(launches["k1"] > 0 and launches["k2"] == 2 * n_tiles, "the bench launched K1 and "
          "called K2 once per tile of its two passes (warm-up, timed)")

    bundle = load_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))
    scene = bundle.scene.to("cuda")
    cam = Camera.build(bundle.camera, 1.0).to("cuda")
    ro, rd, _, k_trace = camera_rays(cam, rng.key(1), SIZE, SIZE, True)
    segments = traced_segments(scene, ro, rd, k_trace, DEPTH)
    print(f"[39] traced_segments at key 1: {segments}; the bench counted {details['segments']}")
    check(details["segments"] == [segments], "the bench counts the segments bench.py counts")
    loss, grads = grad_pass(params_of(scene), scene, ro, rd, k_trace,
                            lambda rad, rows: torch.sum(rad), DEPTH)
    equal = {f: bool(torch.equal(getattr(grads, f), getattr(details["grads"], f)))
             for f in AllParams._fields}
    print(f"[39] grad_pass at key 1: loss {float(loss)!r} (the bench's {float(details['loss'])!r}"
          f"), torch.equal {bool(torch.equal(loss, details['loss']))}; leaves torch.equal {equal}")
    check(bool(torch.equal(loss, details["loss"])) and all(equal.values()),
          "the bench's pass is the library's: loss and five leaves torch.equal")

    k1 = path_kernels(("k1",), scene, ro[:TILE], rd[:TILE], "the bench's key-1 camera tile 0",
                      "39")["k1"]
    tile_rows, p_table = tile_segments(scene, ro, rd, k_trace, DEPTH)
    before = cs.LAUNCHES
    k2_err = compare_k2(cs, p_table, tile_rows, "the bench's key-1 tile 0 sweep (depth 20)",
                        "39")
    k2 = time_k2(cs, p_table, tile_rows, torch.device("cuda"), "39", "bench (depth 20)")
    cs.LAUNCHES = before
    return {"record": rec, "launches": launches, "k1": k1, "k2_err": k2_err, "k2": k2,
            "segments": segments}


def ladder_phase(smi: str) -> dict:
    """Phase 40 on the card: tools/perf/ladder_torch.py's three stages,
    one round at 1024^2 depth GRAD_DEPTH (main(["--reps=1"])), driven with
    every count at 0 just before: K1 launched, K2 by colors and full
    only; then colors and full at key 1: the loss and the color-linear
    leaves torch.equal, colors' fuzz and IR gradients zero.  Returns the ms per
    pass of each stage."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools", "perf"))
    import ladder_torch
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import rng

    reset_counts()
    results = ladder_torch.main(["--reps=1"], depth=GRAD_DEPTH)
    launches = {"k1": ci.LAUNCHES, "k2": cs.LAUNCHES}
    n_tiles = SIZE * SIZE // TILE
    print(f"[40] the ladder at {SIZE}^2 depth {GRAD_DEPTH}, one round: ms per pass {results!r}; "
          f"launches {launches}; card: {smi}")
    # warm-up and PASSES passes of colors and of full, one K2 call a tile each
    check(launches["k1"] > 0 and launches["k2"] == 2 * (1 + ladder_torch.PASSES) * n_tiles,
          "the ladder launched K1, and K2 once per tile of each colors and full pass")
    setup = ladder_torch.Setup(depth=GRAD_DEPTH)
    c_loss, c_grads = ladder_torch.STAGES["colors"](setup, rng.key(1))
    f_loss, f_grads = ladder_torch.STAGES["full"](setup, rng.key(1))
    equal = {f: bool(torch.equal(getattr(c_grads, f), getattr(f_grads, f))) for f in COLOR_LINEAR}
    print(f"[40] colors vs full at key 1: loss {float(c_loss)!r} / {float(f_loss)!r}; "
          f"color-linear leaves torch.equal {equal}")
    check(bool(torch.equal(c_loss, f_loss)) and all(equal.values()),
          "the colors stage's loss and color-linear leaves equal the full stage's")
    check(not bool(c_grads.fuzz.any()) and not bool(c_grads.ir.any()),
          "colors runs no tangent pass")
    return results


def profile_tails_phase(smi: str) -> dict:
    """Phase 41 on the card: tools/perf/profile_pass_torch.py on one tile
    of the full stage at depth GRAD_DEPTH in a fresh process (its exit 0
    means every kernel family's profiled launches equal its wrapper's
    counter), K1 and K2 among them; then the two mesh tails of
    mesh_strategy: seven offset bunnies (34,776 triangles) without
    cluster tables take "sweep", K5 over the whole table, in a
    TAIL_SIZE^2 depth-TAIL_DEPTH render driven with every count at 0 just
    before (K5 launched, K6 not) and K5 held against its dense plain
    version on that render's camera rays (path_kernels) and on 65,536
    rays aimed at the bunnies (copies_rays); C4's bunny
    without sweep constants takes "brute", the plain Moeller-Trumbore
    grid: a BRUTE_SIZE^2 depth-1 render finite and repeated torch.equal,
    no sweep launched, its depth-2 image mean within 1e-3 of K5's, and
    its phase-A winners against K5's on C4's full table for the same
    camera rays (kind and hit equal, t to BRUTE_RTOL, the triangle equal
    where the two t are not tied within it).  Returns what the kernel
    record needs."""
    import dataclasses

    import torch

    from ray_tracing_tpu_torch import CameraParam, EPSILON, Renderer, RendererParam, scenes
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct
    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.ops.intersect import (
        KIND_TRIANGLE,
        SWEEP_MAX_TRIS,
        intersect_scene,
        mesh_strategy,
    )

    code = ("import sys; sys.path.insert(0, 'tools/perf'); import profile_pass_torch; "
            f"profile_pass_torch.main('full', 12, tiles=1, depth={GRAD_DEPTH})")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    print("\n".join(f"[41] {line}" for line in run.stdout.splitlines()))
    check(run.returncode == 0, f"profile_pass_torch exited {run.returncode}: "
          f"{run.stderr[-2000:]}")
    summary = json.loads([x for x in run.stdout.splitlines() if x.startswith("{")][-1])
    print(f"[41] the profile's process took {wall!r} s; busy share {summary['busy_share']!r}")
    check(summary["families"]["K1"] == summary["counted"]["K1"] > 0
          and summary["families"]["K2"] == summary["counted"]["K2"] > 0,
          "the profile lists K1 and K2 with the launches their wrappers counted")

    def bare(scene, prefixes):
        tr = scene.triangles
        return dataclasses.replace(scene, triangles=dataclasses.replace(tr, **{
            f.name: None for f in dataclasses.fields(tr) if f.name.startswith(prefixes)}))

    t0 = time.perf_counter()
    tail_host = bare(scenes.bunny_copies(TAIL_COPIES), ("cl_",))
    print(f"[41] {TAIL_COPIES} offset bunnies: {tail_host.n_triangles} triangles, compiled in "
          f"{time.perf_counter() - t0!r} s")
    check(tail_host.n_triangles > SWEEP_MAX_TRIS and mesh_strategy(tail_host) == "sweep",
          "a table above SWEEP_MAX_TRIS without clusters or BVH takes the sweep")
    tail_cam = CameraParam(look_from=(0.0, 0.55, 0.9), look_at=(0.0, 0.08, -0.6), vfov=60)
    r = Renderer(RendererParam(TAIL_SIZE, TAIL_SIZE, max_depth=TAIL_DEPTH), tail_cam, tail_host,
                 device="cuda")
    r.render(1)  # warm-up
    reset_counts()
    img, tail_ms = elapsed_ms(lambda: r.render(0))
    tail_launches = {"k5": ct.LAUNCHES, "k6": ct.CL_LAUNCHES}
    print(f"[41] {TAIL_SIZE}^2 depth {TAIL_DEPTH} through the sweep tail: {tail_ms!r} ms, mean "
          f"{float(img.mean())!r}; launches {tail_launches}")
    check(bool(torch.isfinite(img).all()) and bool((img >= 0).all()), "the tail's image is finite")
    check(tail_launches["k5"] > 0 and tail_launches["k6"] == 0, "the tail launched K5, not K6")
    tail = tail_host.to("cuda")
    ro, rd, _, _ = camera_rays(Camera.build(tail_cam, 1.0).to("cuda"), rng.key(0), TAIL_SIZE,
                               TAIL_SIZE)
    k5 = path_kernels(("k5",), tail, ro, rd, f"the tail's {TAIL_SIZE}^2 camera rays "
                      f"({tail.n_triangles} triangles)", "41")["k5"]
    before = ct.LAUNCHES
    aimed_err, _ = compare_k5(ct, tail.triangles, *copies_rays(TILE, 41),
                              f"{TILE} rays aimed down at the seven bunnies (seed 41)", "41")
    ct.LAUNCHES = before
    k5["err"] = max(k5["err"], aimed_err)

    c4_host, c4_cam, _ = scenes.bunny()
    brute_host = bare(c4_host, ("cl_", "sw_"))
    check(mesh_strategy(brute_host) == "brute", "a table without sweep constants takes brute")
    br = Renderer(RendererParam(BRUTE_SIZE, BRUTE_SIZE, max_depth=1), c4_cam, brute_host,
                  device="cuda")
    reset_counts()
    a, brute_ms = elapsed_ms(lambda: br.render(0))
    b = br.render(0)
    brute_launches = {"k1": ci.LAUNCHES, "k5": ct.LAUNCHES, "k6": ct.CL_LAUNCHES}
    print(f"[41] C4 {BRUTE_SIZE}^2 depth 1 through brute: {brute_ms!r} ms, mean "
          f"{float(a.mean())!r}; launches {brute_launches}")
    check(bool(torch.isfinite(a).all()) and torch.equal(a, b), "the brute render is finite and "
          "repeats")
    check(brute_launches["k5"] == brute_launches["k6"] == 0, "brute launched no sweep")
    # one bounce more, lit by the sky: the same image as K5's but for
    # Moeller-Trumbore's rounding of t
    lit = RendererParam(BRUTE_SIZE, BRUTE_SIZE, max_depth=2)
    lit_brute = Renderer(lit, c4_cam, brute_host, device="cuda").render(0)
    lit_sweep = Renderer(lit, c4_cam, c4_host, device="cuda").render(0)
    m_brute, m_sweep = float(lit_brute.double().mean()), float(lit_sweep.double().mean())
    print(f"[41] depth 2: mean {m_brute!r} through brute, {m_sweep!r} through K5")
    check(bool(torch.isfinite(lit_brute).all()) and m_sweep > 0
          and abs(m_brute - m_sweep) <= 1e-3 * m_sweep, "brute's depth-2 image mean is K5's")
    c4, brute = c4_host.to("cuda"), brute_host.to("cuda")
    ro, rd, _, _ = camera_rays(Camera.build(c4_cam, 1.0).to("cuda"), rng.key(0), BRUTE_SIZE,
                               BRUTE_SIZE)
    got = intersect_scene(brute, ro, rd, EPSILON, float("inf"))
    want = intersect_scene(c4, ro, rd, EPSILON, float("inf"))
    tri = want.kind == KIND_TRIANGLE
    diff = tri & (got.index != want.index)
    rel = ((got.t - want.t).abs() / want.t)[tri]
    tied = bool((rel[diff[tri]] <= 2 * BRUTE_RTOL).all())
    print(f"[41] brute vs K5 on C4's {BRUTE_SIZE}^2 camera rays: kind mismatches "
          f"{int((got.kind != want.kind).sum())}, {int(tri.sum())} on the mesh, max rel dt "
          f"{float(rel.max())!r}, {int(diff.sum())} other triangles (all tied: {tied})")
    check(torch.equal(got.kind, want.kind) and float(rel.max()) <= BRUTE_RTOL and tied,
          "brute's winners equal K5's where t is not tied")
    return {"k5": k5, "tail_launches": tail_launches, "profile": summary}


MULTICARD_RANKS = 4  # phase 42's ranks at most: the cards of one host


def multicard_phase(smi: str) -> dict:
    """Phase 42 on the card(s): ``python3 multicard_torch.py --ranks K
    --depth GRAD_DEPTH`` as a subprocess, K the cards present up to
    MULTICARD_RANKS (one NCCL rank on the driver's one-card machine).
    The script checks every step itself and exits non-zero on any
    failure; here its record must hold K NCCL ranks, each of which
    loaded the kernels without building them and launched K1 and K2 in
    its direct step.  Returns the record: each rank's K1 and K2 with the
    bound of its own tile, as the rank measured them."""
    import torch

    ranks = min(torch.cuda.device_count(), MULTICARD_RANKS)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, os.path.join(ROOT, "multicard_torch.py"), "--ranks",
                          str(ranks), "--depth", str(GRAD_DEPTH)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = run.stdout.splitlines()
    print("\n".join(f"[42] {line}" for line in lines[:-1]))
    check(run.returncode == 0, f"multicard_torch.py exited {run.returncode}: "
          f"{run.stderr[-3000:]}")
    rec = json.loads(lines[-1])
    print(f"[42] multicard_torch.py: {rec['ranks']} rank(s), backend {rec['backend']}, zy "
          f"{rec['size']}^2 depth {rec['depth']}, {wall!r} s with the start; card: {smi}")
    check(rec["ranks"] == ranks == len(rec["per_rank"]) and rec["backend"] == "nccl",
          f"{ranks} NCCL rank(s), one record each")
    for r in rec["per_rank"]:
        check(r["compiles"] == 0, f"rank {r['rank']} only loaded the kernels")
        check(r["launches"]["k1"] > 0 and r["launches"]["k2"] > 0,
              f"rank {r['rank']}'s direct step launched K1 and K2")
        print(f"[42] rank {r['rank']} ({r['card']}): launches {r['launches']}; K1 bound "
              f"{r['k1']['bound']!r}, K2 bound {r['k2']['bound']!r}; step {r['step_ms']!r} ms, "
              f"all_reduce {r['all_reduce_ms']!r} ms ({r['all_reduce_bytes']} B), all_gather "
              f"{r['all_gather_ms']!r} ms ({r['all_gather_bytes']} B)")
    return rec


def multicard_entries(rec) -> list:
    """The kernel record's entries of phase 42: K1 and K2 of each rank,
    with the launches of that rank's direct step and the numbers it
    measured on its own first tile."""
    out = []
    for r in rec["per_rank"]:
        path = (f"multicard_torch.py rank {r['rank']} of {rec['ranks']} (zy {rec['size']}^2 "
                f"depth {rec['depth']} direct step)")
        k1, k2 = r["k1"], r["k2"]
        out.append(entry(f"phase_a (K1), {path}", "intersect.cu",
                         "ray_tracing_tpu/ops/pallas_intersect.py:116", r["launches"]["k1"],
                         k1["err"], k1["ms"], k1["plain_ms"], k1["bound"]))
        out.append(entry(f"scatter_add (K2), {path}", "scatter.cu",
                         "ray_tracing_tpu/ops/pallas_scatter.py:82", r["launches"]["k2"],
                         k2["err"], k2["ms"], k2["plain_ms"], k2["bound"], k2["library_ms"]))
    return out


def entry(name, source, replaces, launches, err, ms, plain_ms, bnd, library_ms=None):
    """One kernel of the JSON kernel record."""
    return {"name": name, "route": "cuda", "source": f"ray_tracing_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": library_ms}


def path_entries(gallery_run, demo, walk, scale) -> list:
    """The kernel record's entries of phases 35-38: each kernel with the
    launches of its own path's run and the numbers path_kernels (and
    harness_kernels, for K2) measured on that path's rays."""
    k1 = ("intersect.cu", "ray_tracing_tpu/ops/pallas_intersect.py:116")
    gl, gk = gallery_run["launches"], gallery_run["rows"]
    out = []
    names = {"k1": ("phase_a (K1)", *k1), "k3": ("phase_a transformed (K3)", *k1),
             "k4": ("phase_a motion (K4)", "intersect.cu",
                    "ray_tracing_tpu/ops/pallas_intersect.py:127"),
             "k5": ("triangle_sweep (K5)", "triangles.cu",
                    "ray_tracing_tpu/ops/pallas_triangles.py:147"),
             "k6": ("cluster_sweep (K6, serving K7's case)", "triangles.cu",
                    "ray_tracing_tpu/ops/pallas_triangles.py:364 and :287")}

    def path_entry(k, path, launches, row):
        name, source, replaces = names[k]
        return entry(f"{name}, {path}", source, replaces, launches, row["err"], row["ms"],
                     row["plain_ms"], row["bound"])

    for name, rows in gk.items():
        for k, row in rows.items():
            out.append(path_entry(k, f"gallery runner {name}", gl[name][k], row))
    out.append(path_entry("k4", "motion-blur demo", demo["launches"]["k4"], demo["rows"]["k4"]))
    for tile in WALK_TILES:
        out.append(path_entry("k1", f"C4 depth-20 pass through the BVH walk, tile {tile}",
                              walk["launches"][tile]["k1"], walk["rows"]["k1"]))
    out.append(path_entry("k5", "C4 depth-20 pass through the sweep (the walk's reference)",
                          walk["launches"]["sweep"]["k5"], walk["rows"]["k5"]))
    out.append(path_entry("k1", "weak-scaling harness (one NCCL rank)", scale["launches"]["k1"],
                          scale["k1"]))
    out.append(entry(
        "scatter_add (K2), weak-scaling harness (one NCCL rank)", "scatter.cu",
        "ray_tracing_tpu/ops/pallas_scatter.py:82", scale["launches"]["k2"], scale["k2_err"],
        scale["k2"]["kernel"][0], scale["k2"]["plain"][0], scale["k2"]["bound"],
        scale["k2"]["index_add_"][0]))
    return out


def bench_entries(bench, tails) -> list:
    """The kernel record's entries of phases 39 and 41: K1 and K2 with the
    launches of the bench's run, K5 with those of the sweep tail's
    render, each measured on its path's own tensors."""
    k1, k2, k5 = bench["k1"], bench["k2"], tails["k5"]
    return [
        entry("phase_a (K1), bench_torch.py (zy 1024^2 depth 20 fwd+bwd)", "intersect.cu",
              "ray_tracing_tpu/ops/pallas_intersect.py:116", bench["launches"]["k1"], k1["err"],
              k1["ms"], k1["plain_ms"], k1["bound"]),
        entry("scatter_add (K2), bench_torch.py (zy 1024^2 depth 20 fwd+bwd)", "scatter.cu",
              "ray_tracing_tpu/ops/pallas_scatter.py:82", bench["launches"]["k2"],
              bench["k2_err"], k2["kernel"][0], k2["plain"][0], k2["bound"], k2["index_add_"][0]),
        entry("triangle_sweep (K5), the sweep tail above SWEEP_MAX_TRIS (34,776 triangles)",
              "triangles.cu", "ray_tracing_tpu/ops/pallas_triangles.py:147",
              tails["tail_launches"]["k5"], k5["err"], k5["ms"], k5["plain_ms"], k5["bound"]),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ray_tracing_tpu_torch import Renderer, RendererParam, load_scene_json
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import _build
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct
    from ray_tracing_tpu_torch.ops import rng

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s) visible, this run uses cuda:0")
    bundle = load_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))
    scene = bundle.scene.to(dev)

    # 1 and 14. build K1/K3/K4, K2 and K5/K6, one nvcc per source, in parallel
    t0 = time.perf_counter()
    libs = _build.build_all([ci.SOURCE, cs.SOURCE, ct.SOURCE])
    print(f"[1] built {', '.join(os.path.relpath(lib, ROOT) for lib in libs)} "
          f"in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())
    # 14. this slice's kernels are among the builds: K4 as the kSphMotion
    # instances of phase_a_kernel, K6 as cluster_sweep_kernel
    logs = "".join(lib.with_suffix(".log").read_text() for lib in libs
                   if lib.with_suffix(".log").exists())
    k4_built = logs.count("phase_a_kernelILb0ELb0ELb1E") + logs.count("phase_a_kernelILb0ELb1ELb1E")
    print(f"[14] ptxas compiled {k4_built // 2} K4 instances and "
          f"{logs.count('cluster_sweep_kernel') // 2} K6 kernel (0 when the libraries were reused)")
    check(ci._library().phase_a_launch is not None
          and ct._library().cluster_sweep_launch is not None, "K4 and K6 load")

    # 2. K1 against its plain version on the card
    tables = scene.phase_a
    cam = Camera.build(bundle.camera, 1.0).to(dev)
    ro, rd, _, _ = camera_rays(cam, rng.key(0), 1024, 1024)
    err = compare_k1(ci, tables, ro.contiguous(), rd.contiguous(), "1024^2 zy camera rays")
    tile_ro, tile_rd = interior_rays(65536, 0)
    err = max(err, compare_k1(ci, tables, tile_ro, tile_rd, "65536 random rays (seed 0)"))

    # 3. the main path
    param = RendererParam(1024, 1024, max_depth=20)
    renderer = Renderer(param, bundle.camera, bundle.scene, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    images, pass_ms = timed_renders(renderer, range(4))  # phase 5's timings
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = ci.LAUNCHES
    print(f"[3] rendered 4 passes of zy at 1024^2 depth 20 (tile {renderer.tile_size}) "
          f"in {main_s:.2f} s; K1 launches {launches}")
    check(launches > 0, "the main path launched K1")
    for k, img in enumerate(images):
        mean = float(img.mean())
        print(f"[3] pass {k}: mean {mean:.6f} max {float(img.max()):.4f}")
        check(img.shape == (1024, 1024, 3) and img.device.type == "cuda", f"pass {k} shape/device")
        check(bool(torch.isfinite(img).all()) and bool((img >= 0).all()), f"pass {k} finite, >= 0")
        check(0.1 < mean < 0.4, f"pass {k} mean {mean} in 0.1-0.4")
    check(torch.equal(images[0], renderer.render(0)), "render(0) twice is equal")
    print("[3] render(0) repeated: torch.equal")

    # 4. compaction equals the dense loop; the card agrees with the CPU
    small = RendererParam(256, 256, max_depth=20)
    small_renderer = Renderer(small, bundle.camera, bundle.scene, device="cuda")
    img_c, seg_c = small_renderer.render_with_stats(7)
    img_d, seg_d = dense_pass(small_renderer, 7)
    check(torch.equal(img_c, img_d) and seg_c == seg_d, "trace_compacted equals trace at 256^2")
    print(f"[4] 256^2 depth 20: compacted == dense (torch.equal), {seg_c} segments each")
    tiny = RendererParam(64, 64, max_depth=1)
    on_card = Renderer(tiny, bundle.camera, bundle.scene, device="cuda").render(0).cpu()
    on_cpu = Renderer(tiny, bundle.camera, bundle.scene, device="cpu").render(0)
    share = float((on_card == on_cpu).all(dim=-1).float().mean())
    print(f"[4] 64^2 depth 1: {share:.6f} of pixels equal to the CPU render")
    check(share >= 0.999, "depth-1 image on the card equals the CPU render")

    # 5. timings
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _, segments = renderer.render_with_stats(20)
    end.record()
    torch.cuda.synchronize()
    stats_s = start.elapsed_time(end) / 1e3
    kernel_ms, plain_ms, k_dev, p_dev, k1_bound = time_k1(ci, tables, tile_ro, tile_rd)
    k_ms, p_ms = sum(kernel_ms) / 2, sum(plain_ms) / 2
    launch_floor(cs, "5")
    small_renderer = Renderer(small, bundle.camera, bundle.scene, device="cuda")
    small_renderer.render(30)
    pass_wall, pass_dev = profile_device(lambda: small_renderer.render(31))
    print(f"[5] card: {smi}")
    print(f"[5] ms per 1024^2 depth-20 pass: {pass_ms!r} (mean {sum(pass_ms) / len(pass_ms)!r})")
    print(f"[5] render_with_stats: {segments} segments in {stats_s!r} s = "
          f"{segments / stats_s!r} segments/s")
    print(f"[5] K1 on a 65536-ray tile: kernel {kernel_ms!r} ms, plain {plain_ms!r} ms "
          f"(plain, kernel, kernel, plain); bound {k1_bound[0]!r} ms by {k1_bound[1]}")
    if k_dev and p_dev:
        print(f"[5] device time per call (torch.profiler, 20 calls): kernel "
              f"{per_launch(k_dev)!r} ms, plain "
              f"{sum(ms for _, ms in p_dev.values()) / 20!r} ms in "
              f"{sum(n for n, _ in p_dev.values()) / 20!r} device kernels")
        busy = sum(ms for _, ms in pass_dev.values())
        print(f"[5] profiled 256^2 depth-20 pass: wall {pass_wall!r} ms, device busy "
              f"{busy!r} ms ({busy / pass_wall!r} of wall), "
              f"{sum(n for n, _ in pass_dev.values())} device kernels")
        top = sorted(pass_dev.items(), key=lambda kv: -kv[1][1])[:8]
        for name, (n, ms) in top:
            print(f"[5]   {ms!r} ms in {n} launches: {name[:90]}")
    else:
        print("[5] torch.profiler saw no device time: device share not measured")

    print(f"[time] phases 1-5: {time.perf_counter() - t_start:.1f} s")

    def timed(what: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[time] {what}: {time.perf_counter() - t0:.1f} s")
        return out

    grad = timed("phases 6-8 (zy fwd+bwd)", gradient_phases, scene, bundle, smi)
    sj = timed("phases 9-13 (scene.json forward)", scene_json_phases, smi)
    c6 = timed("phases 15, 16, 19 (C6 forward)", bunny_grid_phases, smi)
    mb = timed("phases 17-19 (motion forward)", motion_phases, smi)
    large_err = timed("phase 20 (large tables)", large_table_phase, ci)
    paths = timed("phases 21-22 (scene.json and C6 fwd+bwd)", grad_path_phases, smi)
    sjg, c6g = paths["sj"], paths["c6"]
    timed("phase 23 (kind order)", kind_order_phase)
    cli_run = timed("phases 24-25 (CLI)", cli_phases, smi, renderer.tile_size)
    noise = timed("phase 26 (render_to_noise on C6)", noise_phase, smi)
    gallery = timed("phase 27 (gallery C3, C4)", gallery_phase, smi)
    train = timed("phases 28-30 (train steps, autograd surface)", train_phases, smi, SIZE,
                  GRAD_DEPTH)
    timed("phase 31 (fit examples)", examples_phase, smi)
    wk = timed("phases 32-33 (weekend through the editor and v4ray facade)", weekend_phases, smi)
    web = timed("phase 34 (web editor)", web_phase, smi)
    gallery_run = timed("phase 35 (gallery runner C1-C6)", baselines_phase, smi)
    demo = timed("phase 36 (motion-blur demo)", motion_demo_phase, smi)
    walk = timed("phase 37 (BVH walk)", bvh_phase, smi)
    scale = timed("phase 38 (weak-scaling harness, one NCCL rank)", scaling_phase, smi)
    bench = timed("phase 39 (bench_torch.py at 1024^2 depth 20)", bench_phase, smi)
    timed("phase 40 (perf ladder)", ladder_phase, smi)
    tails = timed("phase 41 (pass profile, mesh tails)", profile_tails_phase, smi)
    multicard = timed("phase 42 (multicard_torch.py, one NCCL rank per card)", multicard_phase,
                      smi)

    # one K1 entry per zy path, each with the count of its own run
    intersect = "ray_tracing_tpu/ops/pallas_intersect.py:116"
    k1 = ("intersect.cu", intersect)
    record = {"kernels": [
        entry("phase_a (K1), zy forward render", *k1, launches, max(err, large_err), k_ms, p_ms,
              k1_bound),
        entry("phase_a (K1), zy fwd+bwd", *k1, grad["k1_launches"], max(err, large_err), k_ms,
              p_ms, k1_bound),
        entry("scatter_add (K2), zy fwd+bwd", "scatter.cu",
              "ray_tracing_tpu/ops/pallas_scatter.py:82", grad["k2_launches"], grad["k2_err"],
              grad["k2_ms"], grad["k2_plain_ms"], grad["k2_bound"], grad["k2_library_ms"]),
        entry("phase_a transformed (K3), scene.json forward render", "intersect.cu", intersect,
              sj["launches"]["k3"], max(sj["k3_err"], large_err), sj["k3_ms"], sj["k3_plain_ms"],
              sj["k3_bound"]),
        entry("triangle_sweep (K5), scene.json forward render", "triangles.cu",
              "ray_tracing_tpu/ops/pallas_triangles.py:147", sj["launches"]["k5"], sj["k5_err"],
              sj["k5_ms"], sj["k5_plain_ms"], sj["k5_bound"]),
        entry("phase_a motion (K4), motion-blur forward render", "intersect.cu",
              "ray_tracing_tpu/ops/pallas_intersect.py:127", mb["launches"]["k4"],
              max(mb["k4_err"], large_err),
              mb["k4_ms"], mb["k4_plain_ms"], mb["k4_bound"]),
        entry("phase_a (K1), C6 forward render", *k1, c6["launches"]["k1"], c6["k1_err"],
              c6["k1_ms"], c6["k1_plain_ms"], c6["k1_bound"]),
        entry("cluster_sweep (K6, serving K7's case), C6 forward render", "triangles.cu",
              "ray_tracing_tpu/ops/pallas_triangles.py:364 and :287", c6["launches"]["k6"],
              c6["k6_err"], c6["k6_ms"], c6["k6_plain_ms"], c6["k6_bound"]),
        # this slice's paths: the fwd+bwd of scene.json and of C6
        entry("scatter_add (K2), scene.json fwd+bwd", "scatter.cu",
              "ray_tracing_tpu/ops/pallas_scatter.py:82", sjg["launches"]["k2"], sjg["k2_err"],
              sjg["k2_ms"], sjg["k2_plain_ms"], sjg["k2_bound"], sjg["k2_library_ms"]),
        entry("phase_a transformed (K3), scene.json fwd+bwd", "intersect.cu", intersect,
              sjg["launches"]["k3"], max(sj["k3_err"], large_err), sj["k3_ms"],
              sj["k3_plain_ms"], sj["k3_bound"]),
        entry("triangle_sweep (K5), scene.json fwd+bwd", "triangles.cu",
              "ray_tracing_tpu/ops/pallas_triangles.py:147", sjg["launches"]["k5"], sj["k5_err"],
              sj["k5_ms"], sj["k5_plain_ms"], sj["k5_bound"]),
        entry("phase_a (K1), C6 fwd+bwd", *k1, c6g["launches"]["k1"], c6["k1_err"], c6["k1_ms"],
              c6["k1_plain_ms"], c6["k1_bound"]),
        entry("scatter_add (K2), C6 fwd+bwd", "scatter.cu",
              "ray_tracing_tpu/ops/pallas_scatter.py:82", c6g["launches"]["k2"], c6g["k2_err"],
              c6g["k2_ms"], c6g["k2_plain_ms"], c6g["k2_bound"], c6g["k2_library_ms"]),
        entry("cluster_sweep (K6, serving K7's case), C6 fwd+bwd", "triangles.cu",
              "ray_tracing_tpu/ops/pallas_triangles.py:364 and :287", c6g["launches"]["k6"],
              c6["k6_err"], c6["k6_ms"], c6["k6_plain_ms"], c6["k6_bound"]),
        # this slice's paths: the CLI on zy, render_to_noise on C6, C3 and C4
        entry("phase_a (K1), zy CLI", *k1, cli_run["launches"]["k1"], max(err, large_err), k_ms,
              p_ms, k1_bound),
        entry("cluster_sweep (K6, serving K7's case), C6 render_to_noise", "triangles.cu",
              "ray_tracing_tpu/ops/pallas_triangles.py:364 and :287", noise["launches"]["k6"],
              c6["k6_err"], c6["k6_ms"], c6["k6_plain_ms"], c6["k6_bound"]),
        entry("phase_a (K1), C3 forward render", *k1, gallery["C3"]["launches"],
              gallery["C3"]["err"], gallery["C3"]["ms"], gallery["C3"]["plain_ms"],
              gallery["C3"]["bound"]),
        entry("triangle_sweep (K5), C4 forward render", "triangles.cu",
              "ray_tracing_tpu/ops/pallas_triangles.py:147", gallery["C4"]["launches"],
              gallery["C4"]["err"], gallery["C4"]["ms"], gallery["C4"]["plain_ms"],
              gallery["C4"]["bound"]),
        # this slice's path: three direct train steps on zy (phase 28)
        entry("phase_a (K1), zy train steps", *k1, train["launches"]["k1"], max(err, large_err),
              k_ms, p_ms, k1_bound),
        entry("scatter_add (K2), zy train steps", "scatter.cu",
              "ray_tracing_tpu/ops/pallas_scatter.py:82", train["launches"]["k2"], grad["k2_err"],
              grad["k2_ms"], grad["k2_plain_ms"], grad["k2_bound"], grad["k2_library_ms"]),
        # this slice's paths: the weekend through the editor and the v4ray
        # façade (phase 32), the web editor's previews (phase 34)
        entry("phase_a (K1), weekend forward render (editor, v4ray facade)", *k1,
              wk["launches"], wk["err"], wk["ms"], wk["plain_ms"], wk["bound"]),
        entry("phase_a (K1), web editor preview", *k1, web["k1"], web["k1_err"], web["k1_ms"],
              web["k1_plain_ms"], web["k1_bound"]),
        entry("phase_a motion (K4), web editor preview", "intersect.cu",
              "ray_tracing_tpu/ops/pallas_intersect.py:127", web["k4"], web["k4_err"],
              web["k4_ms"], web["k4_plain_ms"], web["k4_bound"]),
        entry("triangle_sweep (K5), web editor preview", "triangles.cu",
              "ray_tracing_tpu/ops/pallas_triangles.py:147", web["k5"], web["k5_err"],
              web["k5_ms"], web["k5_plain_ms"], web["k5_bound"]),
    ]}
    # this slice's paths: the gallery runner, the motion demo, the BVH
    # walk's passes and the weak-scaling harness (phases 35-38)
    record["kernels"] += path_entries(gallery_run, demo, walk, scale)
    # this slice's paths: the headline bench and the sweep tail (phases 39, 41)
    record["kernels"] += bench_entries(bench, tails)
    # this slice's path: every rank of multicard_torch.py (phase 42)
    record["kernels"] += multicard_entries(multicard)
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
