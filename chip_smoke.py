#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases, each of which passes or ends the script with a nonzero exit:

1. prints the card's name and power limit, then builds the CUDA kernels
   from ``mujoco_tpu_torch/csrc`` with nvcc (sm_90a);
2. kernel 1 (``linalg_cuda``, LDL solve) against its plain version on
   random SPD batches (n 9, 27, 64; B 3072) and the humanoid's qM, at f64
   (max relative error ≤ 1e-9) and f32 (≤ 1e-4); times the kernel (L2
   flushed before each launch, and L2-warm), the plain version and
   ``torch.linalg.solve`` at the main path's shape, reads the kernel's envs
   per block and resident blocks per SM and times one block per SM and one
   full wave (the L2-warm times of phases 2 and 3 are the profiler's device
   time of the kernel, ``device_ms``);
3. kernel 2 (``newton_cuda``, whole Newton solve) against its plain version
   on the humanoid's rows as ``solver.newton_args`` builds them for the main
   path (B 3072, nefc 162, nv 27) at (iterations, ls_iterations) (1, 4) and
   (4, 4): elementwise at f64 (atol 1e-9 plus rtol 1e-9), and at f32 by the
   statistical criteria of tests/test_newton_kernel.py (≥ 99 % of envs for
   one iteration, ≥ 85 % above, mean objective gap < 2e-3); times kernel and
   plain version at the main path's shape, prints the kept rows per env
   (``newton_cuda.kept_rows``, mean and most) and the bound over them with
   the dense bound over every row beside it, reads the kernel's resident
   blocks per SM and times one block per SM and one full wave;
4. kernel 3 (``megastep_cuda``, the whole rollout in one launch) against
   its plain version on the humanoid, quadruped, ``mixed`` and
   ``spherebox`` snapshots, B 512, from posed states made from a numpy
   seed: f64 one step elementwise (qpos 1e-9, qvel 1e-8, qacc 1e-6, each
   atol plus rtol), f64 25 steps (every env finite, ≥ 99 % of envs with
   qpos within 1e-8), f32 1 and 10 steps (≥ 99 % of envs within 2e-4 of
   the env's largest |value|, qpos and qvel; bodies sunk at most 0.15);
   times the kernel at the main path's shape (humanoid, f32, B 3072, 200
   steps; L2 flushed and L2-warm) and the plain version over 10 steps,
   holds the kernel's 10 steps at B 3072 against that plain output by the
   same f32 criterion, prints (as a witness, not a gate) the f32 shares at
   0.3 deep of kernel against f32 plain and of f32 plain against f64
   plain; prints the occupancy (registers and local, spilled, bytes per
   thread from ``cudaFuncGetAttributes``, shared memory, blocks per SM,
   waves), times one block per SM and one full wave, and runs the stage
   clock (the kernel's timed instantiation,
   ``megastep_cuda.megastep_timed``) on the timing's inputs at B 3072 and
   at one block per SM; the bound counts the mean active rows and slots of
   that run (the dense bound over every row printed beside); then the
   kernel's time at f64 once;
4b. the stage clock at the main path's start: each stage's share and µs
   per env-step, the mean and largest active constraint rows per env-step;
5. the main path: ``rollout.scan_steps`` of the humanoid at f32, B 3072,
   200 steps, check=True, from ``make_batch`` with 0.01·N(0, 1) qpos noise;
   the state must stay finite and the launch counters, zeroed just before,
   must show exactly one megastep launch and no LDL or Newton launch;
6. the stage path of PR 1 (``MJTPU_MEGASTEP=0``), same start, 20 steps:
   finite, exactly one LDL and one Newton launch per step;
7. where the time goes: one 200-step megastep call and 10 warm stage-path
   steps, each under ``torch.profiler`` (CUDA activity only) with wall,
   device busy time and idle share from that one window, the launches and
   the top device kernels, and the same work unprofiled for the tracing's
   cost;
8. 25 steps at f64, B 64, on the card against the same run of the port on
   the CPU (qpos to 1e-8; the stage path on both, f64 does not dispatch to
   the megastep), which ties the GPU path to the CPU path the tests hold
   against mujoco_tpu;
9. (a) the general solver core at full width: the humanoid at MuJoCo's
   default solver options (iterations 100, ls_iterations 50, tolerance
   1e-8; ``zoo.MUJOCO_DEFAULT_SOLVER``), f32, B 3072, 10 steps of
   ``rollout.scan_steps(check=True)`` from the main path's start: every
   env finite, no Newton-kernel or megastep launch, then the same steps one
   at a time with each step's Newton iteration counts read back, where the
   LDL launches must be at least one per step (qacc_smooth) plus one per
   Newton iteration of the env that iterates most; env-steps/s, LDL
   launches per step, Newton iterations per env-step (mean, most), device
   kernel launches per step and the idle share of a profiled window; and 5
   steps at f64, B 8, on the card against the CPU (qpos and qvel to 1e-8,
   atol plus rtol);
10. (b) the model class: each scene of ``zoo.GENERAL`` (equality,
   friction-loss, ball-limit, condim 4/6 and explicit-pair rows, cameras
   and lights) at its own options (100 Newton iterations), posed from a
   numpy seed: f32, B 3072, 5 steps of ``scan_steps``, every env
   finite, at least two LDL launches a step;
   10 steps at f64, B 64, on the card against the CPU (1e-8);
11. (c) the Newton kernel on each scene's rows as ``solver.newton_args``
   builds them, f64, B 3072, 4 iterations: elementwise against its plain
   version (1e-9 plus 1e-9 relative) on every env but at most 1 %; such an
   env passes only if the plain version, rerun on 512 copies of that env's
   own input moved at the last bit (J, aref and M by 1e-15 relative, every
   other copy with its rows reordered), gives the kernel's result
   elementwise on at least one copy (``newton_rows_gate``); printing ne,
   nf and the kept rows;
   then each scene at 4 iterations, f32, B 3072, 5 steps of ``scan_steps``,
   which must be five Newton-kernel launches on those rows;
12. (d) the LDL kernel's backward (``linalg_cuda.SpdSolve``): gradients of
   Σ w·p through the kernel against the same backward by the plain version
   (ḡ = λ = H⁻¹w, H̄ = −λpᵀ), on the humanoid's qM at f64, B 3072 (1e-9
   relative), with the kernel's two launches (forward, backward re-solve);
   both backwards timed alone by the same warmed timer;
13. ``multi_humanoid3`` (nv 81, the reference's 3-humanoid scene) on the
   stage path (``MJTPU_MEGASTEP=0``; the megastep admits it, phase 29):
   f32, B 3072, 10 steps of
   ``scan_steps(check=True)``, every env finite, exactly one LDL and one
   Newton launch per step and no megastep launch; 10 steps at f64, B 8, on
   the card against the CPU (1e-8); the blocked LDL at every order of
   ``WIDE_ORDERS`` (65, 81, 130, 200, 270) at f64 and f32, B 3072, on
   random SPD matrices, against its plain version (f64 elementwise,
   1e-9 + 1e-9·|plain|; f32 by backward error, as ``ldl_gate``) and timed
   (L2 flushed, and L2-warm by events around back-to-back calls) beside
   ``torch.linalg.solve``, its plain version and its bound, with its route
   (shared or device memory), threads, envs per block and blocks per SM;
   the same on the scene's qM (n 81, f32); the wide Newton kernel (a block
   of warps per env) on the scene's rows at f64 (B 3072, it 1, ls 4; envs
   past the J rows it holds in shared memory among them) under phase 11's
   rule, then timed at f32 on those rows with its bound, threads and
   blocks per SM;
14. the Newton kernel's gradient (``newton_cuda.NewtonSolve``): the
   humanoid at f64, B 8, feet in the floor, two differentiated
   ``forward.step`` calls (the stage path), d Σ qpos / d (qvel, ctrl) on the
   card against the CPU (1e-8 relative), one Newton launch per step and
   none in the backward;
15. the slice's scenes: ``humanoid_tendon`` (the humanoid with two limited
   fixed tendons) at f32, B 3072, 10 steps from the main path's start,
   which the megastep refuses: finite, one LDL and one Newton launch per
   step, the tendon limit rows acting in some envs at the start,
   env-steps/s and a profiled window (launches per step, idle share); every
   scene of ``zoo.TENDON`` and ``humanoid_tendon`` 10 steps at f64, B 64, card
   against CPU (1e-8); and on each such scene with rows the Newton kernel
   at 4 iterations, f64, B 3072, under phase 11's rule;
16. ``humanoid_elliptic`` (the flagship at the elliptic cone, impratio 100,
   and implicitfast; the megastep must refuse it): the LDL kernel on the
   general core's first Newton system (M + JᵀWJ + the cone's Hessian
   blocks + reg·I, n 27) against its plain version at f64 (1e-9
   relative), and at f32, where that H is ill-conditioned, by its
   backward error (per env at most 1e-5, the plain version's beside it); f32, B 3072, 20 steps of ``scan_steps(check=True)``
   from the main path's start with the feet pushed 0.12 into the floor
   (at the main path's own start they hang 0.10 above it for ~25 steps):
   finite, exactly two LDL launches per step (qacc_smooth and the one
   Newton iteration) and no other; the envs the guard reset, the active
   frictional slots per env and their share in the cone's middle zone at
   the start and the end, env-steps/s and a profiled window; 10 steps at
   f64, B 16, card against CPU (1e-8); d Σ qpos / d ctrl of one step at
   f64, B 8, card against CPU (1e-8 relative), through ``SpdSolve``'s
   backward (two LDL launches forward, more in the backward);
17. the flagship under RK4 (four forward passes a step): f32, B 3072, 20
   steps from the main path's start, finite, exactly four LDL and four
   Newton launches per step; a profiled window; 10 steps at f64, B 16,
   card against CPU (1e-8); the Newton kernel on the rows of each of the
   first step's four forward passes (f64, B 3072) under phase 11's rule;
18. every scene of ``zoo.OPTIONS`` (PGS pyramidal and elliptic, noslip
   after the general core, after the Newton kernel and on the elliptic
   cone at condim 3 and 4, the elliptic cone, RK4, implicit and
   implicitfast): card against CPU at f64, B 64 (6 steps, fewer where a
   step takes seconds: ``SCENE_NSTEP``), then at f32, B 3072, finite, its
   env-steps/s, kernel launches and a profiled step (the slowest scenes
   timed on that profiled step alone).

19. ``multi_humanoid10`` (ten humanoids in one scene, nv 270, nefc
   1,620, ten trees) through the island solve, and with islands disabled
   on the stage path (``MJTPU_MEGASTEP=0``; the Newton kernel at nv 270;
   the megastep admits that scene, phase 29): f32, B 3072 (halved while one step
   peaks above 60 % of the card's memory; the B used is printed), every
   foot in the floor, 20 steps of ``scan_steps(check=True)`` each: finite,
   exactly two LDL launches per step and no other on the island path (its
   qacc_smooth at n 270 and the one Newton iteration's B·10 island
   systems of order 27), one LDL and one Newton launch per step on the
   monolithic path; env-steps/s, launches and idle share of a profiled
   2-step window and peak memory of each, and the island path's rate
   over the monolithic one; the LDL kernel on a step's island Newton
   systems (``island.newton_systems``) against its plain version, f64
   elementwise (B 256) and f32 by backward error, as phase 16 does, and
   timed at f32 (L2 flushed, and L2-warm by events) with its bound,
   the plain version and ``torch.linalg.solve``; the n-270 LDL (shared
   memory at f32, device memory at f64) on the scene's qM at the full
   width against its
   plain version, f32 by backward error and f64 elementwise, and timed
   at both; the Newton kernel at nv 270 on the monolithic path's rows
   against its plain version, f64 at B 256 under phase 11's rule and f32
   at the full width under phase 6's (it1), and timed at f32, each beside
   its plain version and bound; 5 steps at f64, B 4, on the card against
   the CPU on the island path (1e-8);
20. ``replicate4`` (four self-colliding humanoids, nv 108, three dynamic
   pair groups of 24 pairs): f32, B 3072, feet in the floor, 20 steps:
   finite, exactly 1 + iterations + 1 (eulerdamp) LDL launches per step
   and no other, env-steps/s, launches and idle share, the candidate
   pairs each env drops beyond the budget (``Data.warning``, mean and
   most, at the start and the end); 5 steps at f64, B 4, card against CPU
   (1e-8) with the selected geom pairs (``Contact.geomids``) identical at
   every step;
21. sleep: ``sleep_stack`` 100 steps at f64, B 3 (one env at rest, one
   rolling its ball into the stack, one pushing the box), card against
   CPU: ``tree_asleep`` identical at every step, qpos to 1e-8, the resting
   env's trees all asleep at the end; ``sleep_stack`` at f32, B 3072, the
   same three starts by thirds, 100 steps: finite, LDL launches and no
   megastep, env-steps/s, launches, the share of trees asleep at the end
   (more than 0: the sleeping branches run at full width) by start, and
   the idle share of a profiled 2-step window of the partly sleeping
   batch; ``multi_humanoid10_sleep`` at f32, B 3072, 20 steps: finite,
   two LDL launches per step, env-steps/s, launches, idle share, and the
   share of trees asleep at the end (printed, not gated);
22. the colliders of the collision breadth slice (``collider_cases``:
   plane-cylinder, plane-ellipsoid, sphere-cylinder, capsule-box, box-box,
   MPR on two ellipsoids and on a box and the rock's mesh, plane-, sphere-
   and capsule-mesh on the rock, and the height-field sphere, capsule,
   box, cylinder, ellipsoid and mesh on the bowl), each on 4,096 seeded
   poses (touching, separated and deep) at f64 on the card against the
   CPU, elementwise to 1e-10 absolute plus relative; an env that misses
   passes only if 2,048 copies of its input moved at the last bit
   (``last_bits``), rerun on the CPU or on the card, give the other
   side's result, move as far themselves, or bracket it where they
   disagree (``judge_envs``; at most 2 % of envs, 5 % for MPR); printing
   per collider the f32 distances' gap to the f64 ones (median, p99,
   most, and the slots a contact at one precision only) and its ms and
   kernel launches per call at f32;
23. the slice at full width: ``rock`` (the 1,000-vertex mesh scene, nv
   18, which the megastep refuses), f32, B 3072, its bodies at rest on
   each other, 25 steps of ``scan_steps(check=True)`` on the stage path:
   finite, at least two LDL launches per step and no other kernel's; its
   env-steps/s, launches per step, Newton iterations per env-step (10
   steps one at a time, with the LDL launches at least one per step plus
   one per iteration of the env that iterates most), the share of envs
   the guard reset, peak memory and the idle share of a profiled 2-step
   window; the LDL kernel on the rock's Newton systems at n 18 against its
   plain version (f32 by backward error, f64 elementwise) and timed
   beside its bound, the plain version and ``torch.linalg.solve``;
   ``box_pile``, ``grasp`` and ``hfield_bowl`` at f32, B 3072, 10 steps
   each with env-steps/s; and 5 steps at f64, B 4, of each of the four
   scenes on the card against the CPU, each step from the CPU's state
   (qpos and qvel to 1e-8 absolute plus relative, ``judge_envs`` with 256
   copies);
24. sensors and activation state: ``humanoid_sensors`` (the flagship with
   87 sensors, 126 values, and 21 FILTEREXACT actuators, which the
   megastep must refuse), f32, B 3072, the main path's start with the
   feet 0.02 in the floor and ctrl 0.5·N(0, 1), 50 steps of
   ``scan_steps(check=True)``: qpos, qvel, act and the sensordata of the
   final state finite, exactly one LDL and one Newton launch per step and
   no megastep launch, a touch above 0 in some env; env-steps/s, peak
   memory, launches per step and the idle share of a profiled 2-step
   window, the same with ``DisableBit.SENSOR`` set (their difference the
   sensor stages' launches per step) and of the flagship from the same
   start on the stage path (the activations' share), and the device
   kernels of one call of each sensor stage (the most of 5 profiled
   calls); 20 steps at f64, B 8, and the five small scenes
   of ``zoo.SENSORS`` 10 steps at f64, B 64, each step from the CPU's
   state on the card and the CPU: qpos, qvel, act and sensordata within
   1e-8 absolute plus relative, an env that misses judged by last-bit
   copies (``judge_envs``, 256 copies);
25. the rest of the actuators, sensors and passive forces:
   ``quadruped_sim2real`` (the quadruped's 12 motors as DC motors in
   position mode behind an 8 ms action delay, a delayed IMU, foot contact
   sensors and a 15-ray height scan, 77 sensor values; the megastep must
   refuse it), f32, B 3072, from the stand keyframe lowered 0.2 m onto the
   floor with 0.01·N(0, 1) qpos noise and ctrl the keyframe's joints plus
   0.1·N(0, 1), 50 steps of ``scan_steps(check=True)``: qpos, qvel, act,
   history and the final state's sensordata finite, exactly one LDL and
   one Newton launch per step and no megastep launch, every rangefinder
   above 0 in every env, a foot contact in some env; env-steps/s, peak
   memory, launches per step and the idle share of a profiled 2-step
   window, and the same with ``DisableBit.SENSOR`` set and with the delays
   0; one step's device kernels (the most of 3 profiled calls) as built,
   with the sensors disabled, with the delays 0 and with no history buffer
   in use (the differences the sensor stages', the delays' and the
   history's); the LDL
   and Newton kernels on the arguments one step at f64, B 3072, gives
   them, against their plain versions (the LDL at f64 elementwise and at
   f32 by backward error, the Newton kernel by phase 11's rule); 20 steps
   at f64, B 8, of it and 5 steps at f64, B 64, of each of the ten small
   scenes of ``zoo.ACTUATION`` and the four SO3 and PID scenes of
   ``zoo.ACTUATION_CARRIED``, each step from the CPU's state on the
   card and the CPU: qpos, qvel, act, history and sensordata within 1e-8
   absolute plus relative, an env that misses judged by last-bit copies
   (``judge_envs``, 256 copies).
26. the control loop: the quadruped at f32, B 3072, reset to its ``stand``
   keyframe (``state.reset_data_keyframe``, its id by ``name2id``) and a
   ``get_state``/``set_state`` round trip under INTEGRATION, exact and
   card = CPU bit for bit, with µs per call; ``inverse`` of the humanoid
   at f64, B 3072, from a numpy seed, card against CPU (1e-8), then under
   implicitfast with INVDISCRETE (one LDL launch, ``discrete_acc``),
   and ``compare_fwd_inv``'s two norms after a forward pass; the
   humanoid's ``transition`` (its 75 tangent directions laid along the
   batch, one step of B·75 copies through the LDL and Newton kernels and
   their forward-mode rules) at f32, B 256, finite with both kernels
   launched and its ms per env, at f64 on 8 envs card against CPU
   (1e-7), and its A at f64, B 256, against its own centered
   ``transition_fd`` (eps 1e-6, 1e-4); the same of the humanoid with
   every admitted leaf per env (f32, B 256, ms per env and launches;
   f64, B 8, card against CPU, 1e-7) and of ``tendon_rows`` (its
   tendon-armature bias carries the tangents; f32, B 256, and f64, B 8);
   the humanoid with all eighteen randomizable leaves drawn per env from a
   seed (``rollout.draw_leaves``, ``randomize_model``,
   ``step_randomized``), 20 steps at f64, B 3072, each step of the CPU's
   state on the card and the CPU (1e-8, an env that misses judged by
   last-bit copies with its leaves on both sides, ``judge_envs``), four
   envs of the card's own 20 steps each against a plain Model holding its
   leaves (1e-8), the megastep's refusal, then at f32, B 3072, 20 steps
   with one LDL and one Newton launch per step and no megastep,
   env-steps/s and device kernels per step beside the plain stage path's
   in the same call; ``quadruped_sim2real`` at implicitfast with the
   twelve leaves a sim-to-real user draws per env, 20 steps of
   ``step_randomized`` at
   f32, B 3072 (finite, launches per step, env-steps/s beside its plain
   stage path), and 10 steps at f64, B 8, card against CPU as above.
27. the flexes (``zoo.FLEX``): the megastep's gate and
   ``rollout.megastep_eligible`` refuse every scene; each scene at f64,
   B 8, 5 steps from a start in contact (``FLEX_START``), each step from
   the CPU's state on the card and the CPU: qpos and qvel within 1e-8 and
   the vertices of the slots in contact equal (``flex_picks``), an env
   that misses judged by last-bit copies (``judge_envs``); the LDL kernel
   on ``humanoid_hammock``'s qM at n 258 (f32 by backward error, f64
   elementwise 1e-9 relative; the full batch) and the Newton kernel on
   its rows at nv 258 (f64 B 256 by phase 11's rule, f32 at the full
   batch by phase 6's), each timed beside its plain version, its bound and
   ``torch.linalg.solve``; the hammock at f32 and the full batch (B 3072,
   or halved where one step would pass 60 % of the card's memory), 20
   steps on the stage path: exactly one LDL and one Newton launch per
   step, finite, env-steps/s, the envs the guard reset, peak memory, the
   idle share of a profiled 2-step window and the device kernels of one
   step's flex stage, flex passive forces and flex collisions.
28. ray and render: every ``zoo.RENDER`` scene with a camera at f64, B 8,
   32×32 (shadows on for the spot-lit scenes), card against CPU from the
   same state: depth and RGB within 1e-8 absolute plus relative where seg
   agrees, a pixel that misses (seg, depth or RGB) passed only if 64
   copies of its ray moved by at most 1e-13 relative, rerun on the CPU,
   give the card's result or, rerun on the card, the CPU's
   (``pixel_judge``, at most 1 % of pixels); ``update_scene`` and
   ``skin_update`` within 1e-10; then the pixel loop of
   ``humanoid_pixels`` (the flagship with dm_control's visuals) at f32,
   B 3072 (halved while a frame's estimated peak passes 60 % of the
   card's memory; printed), 64×64 from the ``side`` camera: 10 control
   steps, each ctrl uniform in ctrlrange from a numpy seed, 5 steps of
   ``scan_steps(check=True)``, the frames rebuilt (kinematics, com_pos,
   camlight) and a frame of every env: exactly one megastep launch per
   control step and no other, every frame finite, RGB in [0, 1], depth >
   0 where seg ≥ 0, the humanoid in the frame of at least 99 % of envs;
   env-frames/s, the megastep's and the frames' device ms, peak memory
   beside its estimate; one frame's ms with and without shadows beside
   the bound of the bytes it writes, device kernels (the ray pass's
   apart) and the idle share of a profiled frame; ms per megastep launch
   of 5 steps; the same loop at f64 (the stage path), B 256, each
   control step's state framed at f64 and, cast to f32, rebuilt and
   rendered at f32: seg equal on ≥ 99 % of pixels, depth within 1e-4
   relative where seg agrees, and every pixel that misses on a seg edge
   of one of the two images or, at most 1e-4 of the pixels, decided by
   f32 rounding: 64 copies of its ray moved by at most 1e-6 relative,
   cast at one precision, give the other's pixel on one copy
   (``precision_loop``); a witness, not a gate: the envs each control
   step run at f32 through the megastep from the f64 state leaves off by
   the megastep's f32 rule; ``skin_update`` ms on the sleeve at B 3072.
29. the wide megastep (nv > 64; ``megastep_cuda.route``): ``multi_humanoid3``
   (nv 81, the wide route in shared memory at f32) and ``multi_humanoid10``
   with islands disabled (nv 270, the wide route in device memory) at f32,
   B 3072, 20 steps of ``scan_steps(check=True)`` from the main path's
   start: finite, exactly one megastep launch and no LDL or Newton launch,
   env-steps/s (first and second call) beside the same scene's stage path
   (``MJTPU_MEGASTEP=0``, 3 warm steps) and peak memory; the kernel's time
   (20 steps, L2 flushed) beside its bound (``megastep_flops`` over the
   active rows the stage clock counts) and the plain version's time per
   step, the stage clock per stage, registers, spills, shared and device
   memory per env and blocks per SM at f32 and f64; the kernel against its
   plain version at f32, B 3072, one step by phase 4's f32 rule (the plain
   version timed on that call), at f64, B 256, 3 steps under phase 11's rule (an
   env off elementwise passes only if the other side, rerun on 64 last-bit
   copies of its state, accounts for it: ``megastep_gate_f64``), and
   ``multi_humanoid3``'s kernel on the card against ``megastep_plain`` on
   the CPU at f64 (B 8, 5 steps, 1e-8) and its f64 time at B 3072 beside
   its bound and the plain version's; the humanoid set on the wide route
   at f64 (one tile) under the same rule; the host's shared-memory count
   of every route against the kernel's own (``layout_counts``).
30. SDF collision and the plugin callbacks: the megastep's gate refuses
   every ``zoo.SDF`` scene; ``sdf_nutbolt`` (a free nut threaded on a
   fixed bolt, two SDF groups of 40 descent starts, 320 rows) at f32,
   B 3072, ctrl uniform in [-2, 2] per env from a numpy seed, 20 steps of
   ``scan_steps(check=True)`` on the stage path: finite, exactly one LDL
   and one Newton launch per step and no megastep launch; env-steps/s,
   peak memory, device kernels per step and the idle share of a profiled
   2-step window, and the SDF collision pass's device ms and kernels in
   one step; the LDL kernel on its qM (n 6) at f64 and f32 against its
   plain version (phase 2's tolerances) and the Newton kernel on its rows
   (nv 6, 320 rows, 4 iterations, 8 linesearch steps) at f64 under phase
   11's rule and at f32 by phase 3's criteria, each timed beside its
   bound, its plain version and ``torch.linalg.solve``; every ``zoo.SDF``
   scene 10 steps at f64, B 64, each step of the CPU's state on the card
   and the CPU: qpos, qvel and every slot's dist within 1e-8, an env that
   misses judged by last-bit copies on both sides (``judge_envs``; moves
   of 1e-15 relative, then up to 1e-12 where a box's corner start keeps
   its bits); the USER gain, bias, sensor and passive callbacks of
   tests/test_plugin.py as torch functions on ``sensor_suite``
   (``callback_model``), 20 steps at f64, B 64, card = CPU.
31. the MJCF compiler (``mujoco_tpu_torch.compiler``) under an import
   guard that makes ``import mujoco`` raise: the port's
   ``models/assets/humanoid.xml`` compiled with set_const on the card at
   f64 and again on the CPU, every CompiledModel field equal (integers
   exactly, floats within 1e-12 relative), each compile's seconds printed
   beside the card's name and power limit; its Model at f64 against the
   committed ``humanoid.npz`` within 1e-8 but the differences the native
   build records (unnamed actuators named, ``vis_meta`` colours within
   2.4e-8, ``opt.sleep_tolerance`` 0 against 1e-4), each difference
   listed; the compiled model at f32 through ``make_batch`` (B 3072, the
   main path's start) and ``scan_steps(m, d, 200, d_fresh, check=True)``:
   finite, exactly one megastep launch and no LDL or Newton launch, qpos
   and qvel against the same run from the snapshot's Model by phase 6's
   f32 rule (``check_f32``); ``snapshot.MUSCLE_XML`` compiled on the card
   and on the CPU: its length ranges (the batch of 2·nu envs × 1,000 steps
   of ``setconst.length_range_step``, at least two LDL launches a step)
   within 1e-9 of each other and of the committed ``muscle.npz``, with the
   batch's width, its seconds and its LDL and Newton launches per step.
32. the tools on top of the engine at f64: ``sysid`` on the humanoid, its
   21 hinge dampings over 50 steps of ctrl 0.3·sin(0.1·t + j) observed by
   the port's own ``simulate``, the fit from 1.01× the true values (from
   1.2× the reference's Gauss-Newton leaves the basin: PERF.md §6) with
   ``max_iter`` 10: the Jacobian at the start on the card against the same
   call on the CPU (largest difference within 1e-8 of the largest entry),
   at least one LDL and one Newton launch per step of its rollout (B 21),
   x on the true dampings within 1e-6 relative, iterations, cost, seconds
   per trip; ``minimize.ik`` on ``humanoid_sensors`` (``hand_r`` moved 0.1
   m, the free joint held): the site within 1e-6 m of its target, x card
   = CPU within 1e-8; ``print_model`` of the humanoid card = CPU,
   ``box_qp`` (n 27) and ``chol_solve_band`` ((27, 3, 6)) card = CPU within
   1e-12; ``testspeed`` of the humanoid at f32, B 3072, 200 steps, from
   its snapshot and from ``models/assets/humanoid.xml``: one megastep
   launch and no LDL or Newton launch per timed call, finite, env-steps/s
   beside phase 5's; ``parallel.dryrun.dryrun_multichip`` on the card;
   ``io._tree_topology`` of ``multi_humanoid10`` timed on the host. The
   CPU side runs in a process of its own beside the card's fit.
33. the per-env leaves past the eighteen: the pixel-RL loop of
   ``humanoid_pixels`` with its nine render leaves (``rollout.
   RENDER_LEAVES``), ``geom_size`` and ``jnt_range`` drawn per env, f32, B
   3072, 64×64, 10 control steps of 5 physics steps of
   ``step_randomized`` and a frame of every env with the per-env Model
   after each: the humanoid in 99 % of every frame, exactly one LDL and
   one Newton launch per physics step, env-frames/s beside phase 28's
   plain loop; the LDL and Newton kernels on the randomized humanoid's qM
   and rows at f64, B 3072, against their plain versions (phase 25's
   ``path_kernels_gate``); the same loop at f64, B 16, 2 control steps,
   card = CPU (the states by ``randomized_card_vs_cpu``, the 32×32 frames
   by ``pixel_judge``); ``humanoid_tendon`` with the eleven tendon leaves
   and ``quadruped_sim2real`` at implicitfast with ``SIM2REAL_LEAVES`` and
   the three actuator leaves, each f32, B 3072, 20 steps of
   ``step_randomized`` (finite, one LDL and one Newton launch per step,
   env-steps/s, the idle share of a profiled 3-step window) and f64, B
   256, 5 steps card = CPU;
34. ``rollout.scan_steps(mesh=)``: the humanoid at f32, B 3072, 200 steps,
   plain, over ``["cuda:0"]`` (one megastep launch, bitwise the plain
   call) and over ``["cuda:0", "cuda:0"]`` (two launches of 1536 envs, no
   LDL or Newton launch, each env bitwise the unsplit call's or by phase
   4's f32 rule), env-steps/s of each; ``quadruped_sim2real`` at
   implicitfast with the frame and contact leaves it reaches
   (``SIM2REAL_NEW_LEAVES``) beside phase 33's, as phase 33's side paths
   (f32, B 3072, 20 steps, one LDL and one Newton launch per step, the
   idle share; f64, B 256, 5 steps card = CPU), and the LDL and Newton
   kernels on its f64 qM and rows against their plain versions; the six
   pair leaves on ``pair_condim6`` at f64, B 64, 5 steps card = CPU; the
   three ``examples_torch/`` scripts at their defaults, each in its own
   process (exit 0, its seconds, one megastep launch in
   ``rollout_batch.py``, the damping within 1e-4 in ``sysid_fit.py``).

The kernels' ``launches`` are counted in the run of their own path: the
megastep's in phase 5, the LDL's and the Newton kernel's in phase 6; each
kernel's ``launches_by_path`` adds its counts in the runs of phases 9 to 11
and 13 to 34 (phase 26's ``discrete_acc``, ``transition`` and
``randomized``; phase 27's ``humanoid_hammock``; the megastep's phase
28 ``humanoid_pixels`` and phase 29's ``multi_humanoid3`` and
``multi_humanoid10_monolithic``; phase 30's ``sdf_nutbolt``; phase 31's
``compiled_humanoid`` and ``compiler_lengthrange``; phase 32's
``sysid_jacobian`` and ``testspeed``; phase 33's ``randomized_pixels``,
``randomized_humanoid_tendon`` and ``randomized_quadruped_sim2real``;
phase 34's megastep ``mesh_1`` and ``mesh_2`` and LDL and Newton
``randomized_quadruped_sim2real_frames``); the
megastep's ``wide`` entry holds phase
29's times per scene; the LDL's ``wide`` entry holds phase 13's table (each order
of ``WIDE_ORDERS`` at f32 and f64, and the scene's qM at n 81) and the
Newton kernel's its phase-13 times at nv 81; the LDL's ``island`` and ``n270``
entries and the Newton kernel's ``nv270`` entry hold phase 19's times,
the LDL's ``n18`` entry phase 23's, the LDL's ``n258`` and the Newton
kernel's ``nv258`` entries phase 27's, and the LDL's ``n6_sdf`` and the
Newton kernel's ``nv6_sdf`` entries phase 30's.
Each phase's seconds are printed as it ends.
It prints one JSON line describing each kernel, the card line, and last
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 3072
NSTEP = 200
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32 without tensor cores
PEAK_FP64_FLOPS = 34e12         # H100 SXM fp64 without tensor cores
# device kernels of the stage path's two hand-written kernels, by name
HANDWRITTEN = ("ldl_regs_kernel", "ldl_block_kernel", "newton_kernel")


def card_line() -> str:
  r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True, timeout=60)
  return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=30, warmup=3) -> float:
  """Mean device time of fn in ms, by CUDA events around reps calls (its
  inputs stay warm in L2 from one call to the next)."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


_FLUSH = None


def cuda_ms_cold(fn, reps=30, warmup=3) -> float:
  """Mean device time of fn in ms with L2 flushed before each call: a
  256 MiB buffer (five times the H100's 50 MB L2) is overwritten, then CUDA
  events bracket the call alone."""
  global _FLUSH
  if _FLUSH is None:
    _FLUSH = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
  for _ in range(warmup):
    fn()
  events = []
  for _ in range(reps):
    _FLUSH.fill_(1.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    events.append((start, end))
  torch.cuda.synchronize()
  return sum(s.elapsed_time(e) for s, e in events) / reps


def device_ms(fn, reps=30, warmup=3, attempts=5) -> float:
  """Mean device time in ms of the hand-written kernel that fn launches
  (its inputs warm in L2), from torch.profiler's CUDA activity: the
  kernel's own duration, without the host time of its wrapper, which
  events around back-to-back calls measure instead when the kernel is
  shorter. A window counts only if the profiler saw every one of the
  reps launches; the profiler sometimes delivers fewer (7 of 30 in one
  run of phase 3 on an H100), so a window that misses some is run
  again, up to ``attempts`` times, and the script fails if none is
  whole."""
  from torch.profiler import ProfilerActivity, profile
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  seen = []
  for _ in range(attempts):
    # acc_events: keep the events of every collection cycle of the window
    # (the profiler warns that it clears them at the end of each cycle)
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(k in e.name for k in HANDWRITTEN)]
    seen.append(len(times))
    if len(times) == reps:
      if len(seen) > 1:
        print(f"device_ms: the profiler saw {seen} of {reps} launches in "
              f"its windows; the last one is whole", flush=True)
      return sum(times) / reps / 1e3
  raise AssertionError(f"the profiler saw {seen} kernel launches in "
                       f"{attempts} windows of {reps} calls")


def bound(nbytes: float, flops: float, dtype) -> tuple:
  """Least time the card could take: bytes over HBM rate vs operations over
  the peak rate of their type; returns (ms, 'bytes' | 'operations')."""
  peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_FP64_FLOPS
  t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
  return (max(t_bytes, t_ops) * 1e3,
          "bytes" if t_bytes >= t_ops else "operations")


def ldl_flops(n: int) -> int:
  """Arithmetic of one in-place LDLᵀ factor and the three solves."""
  factor = sum((n - k - 1) + 2 * (n - k - 1) * (n - k) // 2 + 1
               for k in range(n))
  return factor + 2 * n * (n - 1) + n


def ldl_bound(nbatch: int, n: int, dtype) -> tuple:
  """An SPD solve needs only H's lower triangle (all the kernel reads), g,
  and writes p."""
  item = 8 if dtype == torch.float64 else 4
  return bound(nbatch * (n * (n + 1) // 2 + 2 * n) * item,
               nbatch * ldl_flops(n), dtype)


def newton_flops(nefc: int, nv: int, iterations: int, ls_iter: int) -> int:
  """Arithmetic of the whole Newton solve per env, counted from the
  algorithm: each objective evaluation is J·x (2·nefc·nv), the row update
  (~8 per row) and M·dx (2·nv²); each iteration adds Jᵀf, the lower
  triangle of JᵀWJ (3·nefc per entry), the LDL, J·p, M·p and ls_iter row
  passes (~12 per row)."""
  objective = 2 * nefc * nv + 8 * nefc + 2 * nv * nv + 4 * nv
  per_iter = (objective + 2 * nefc * nv + 3 * nefc * nv * (nv + 1) // 2
              + nv * nv + ldl_flops(nv) + 2 * nefc * nv + 2 * nv * nv
              + ls_iter * 12 * nefc + 2 * nv)
  return 2 * objective + iterations * per_iter + objective + 2 * nefc * nv


def humanoid_state(m, nbatch, seed):
  """A forward-evaluated batch of the humanoid (or of several, each root
  lowered alike), feet pushed into the floor, with the solver inputs
  filled in (this launches the LDL kernel) and a warmstart near the smooth
  acceleration, so the solve's cost pick is not one-sided."""
  from mujoco_tpu_torch.ops import forward
  from mujoco_tpu_torch.parallel import rollout
  gen = torch.Generator(device="cuda").manual_seed(seed)
  d = rollout.make_batch(m, nbatch)
  qpos = d.qpos + 0.03 * torch.randn(d.qpos.shape, generator=gen,
                                     device="cuda", dtype=d.qpos.dtype)
  for j in np.nonzero(np.asarray(m.jnt_type) == 0)[0]:   # free roots
    qpos[:, int(m.jnt_qposadr[j]) + 2] -= 0.12
  qvel = 0.5 * torch.randn(d.qvel.shape, generator=gen, device="cuda",
                           dtype=d.qvel.dtype)
  d = forward.fwd_acceleration(m, forward.fwd_actuation(
      m, forward.fwd_velocity(m, forward.fwd_position(
          m, d.replace(qpos=qpos, qvel=qvel)))))
  return d.replace(qacc_warmstart=0.9 * d.qacc_smooth)


def phase_ldl(report, details):
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import linalg_cuda
  gen = np.random.default_rng(0)
  worst64 = 0.0
  for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
    cases = []
    for n in (9, 27, 64):
      a = gen.standard_normal((B, n, n))
      h = a @ a.transpose(0, 2, 1) + n * np.eye(n)
      cases.append((f"spd n{n}", torch.tensor(h, dtype=dtype, device="cuda"),
                    torch.tensor(gen.standard_normal((B, n)), dtype=dtype,
                                 device="cuda")))
    d = humanoid_state(zoo.humanoid(dtype), B, 1)
    cases.append(("humanoid qM", d.qM.contiguous(),
                  d.qfrc_smooth.contiguous()))
    for name, h, g in cases:
      p = linalg_cuda.spd_solve_kernel(h, g)
      torch.cuda.synchronize()
      ref = linalg_cuda.spd_solve_plain(h, g)
      abs_err = (p - ref).abs().max().item()
      rel = abs_err / ref.abs().max().item()
      print(f"ldl_solve {str(dtype)[6:]} {name}: max rel err {rel:.3e} "
            f"(limit {tol:g})", flush=True)
      if not np.isfinite(rel) or rel > tol:
        raise AssertionError(f"ldl_solve disagrees with its plain version: "
                             f"{name} {dtype} rel err {rel}")
      if dtype == torch.float64 and name == "humanoid qM":
        worst64 = abs_err
  # time at the main path's shape and type: humanoid qM, f32, B 3072
  h, g = cases[-1][1], cases[-1][2]
  n = h.shape[1]
  kernel_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_kernel(h, g))
  warm_ms = device_ms(lambda: linalg_cuda.spd_solve_kernel(h, g))
  plain_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_plain(h, g))
  library_ms = cuda_ms_cold(lambda: torch.linalg.solve(h, g))
  bound_ms, bound_by = ldl_bound(B, n, torch.float32)
  print(f"ldl_solve f32 B{B} n{n}: kernel_ms {kernel_ms:.4f} (L2 flushed; "
        f"L2-warm {warm_ms:.4f}) plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} (torch.linalg.solve) bound_ms {bound_ms:.5f} "
        f"({bound_by})", flush=True)
  # what sets the time: envs per block, resident blocks per SM, and the
  # time of one block per SM against one full wave
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  occ = linalg_cuda.occupancy(n, torch.float32)
  per_block, per_sm = occ["envs_per_block"], occ["blocks_per_sm"]
  waves = {}
  for k in (sms * per_block, sms * per_block * per_sm):
    hk, gk = h[:k].contiguous(), g[:k].contiguous()
    waves[k] = device_ms(lambda: linalg_cuda.spd_solve_kernel(hk, gk))
  one, wave = waves[sms * per_block], waves[sms * per_block * per_sm]
  print(f"ldl_solve f32 occupancy: {per_block} envs per block, {per_sm} "
        f"blocks/SM on {sms} SMs ({B / (sms * per_block * per_sm):.2f} waves "
        f"at B{B}); one block per SM ({sms * per_block} envs) {one:.4f} ms, "
        f"one full wave ({sms * per_block * per_sm} envs) {wave:.4f} ms",
        flush=True)
  details["ldl_solve"] = dict(l2_warm_ms=warm_ms, envs_per_block=per_block,
                              blocks_per_sm=per_sm, sms=sms,
                              one_block_per_sm_ms=one, one_wave_ms=wave)
  report["ldl_solve"] = dict(
      name="ldl_solve", route="cuda",
      source="mujoco_tpu_torch/csrc/ldl_solve.cu",
      replaces="mujoco_tpu/ops/linalg_tpu.py:34", max_abs_err=worst64,
      ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
      library_ms=library_ms)


def newton_violation(out_k, out_p, rtol=1e-9, atol=1e-9) -> dict:
  """Per output, the largest |kernel − plain| / (atol + rtol·|plain|)
  (≤ 1 passes). The stat rows' improvement is a difference of two costs,
  so both columns take the env's costs, |improvement| + |cost|, as scale."""
  worst = {}
  for name, a, b in zip(("x", "force", "qfrc", "stat"), out_k, out_p):
    scale = b.abs()
    if name == "stat":
      scale = scale.sum(-1, keepdim=True)
    worst[name] = ((a - b).abs() / (atol + rtol * scale)).max().item()
  return worst


def newton_f32_gate(tag, args, out_k, out_p, need) -> dict:
  """The Newton kernel against its plain version at f32: at least the
  share ``need`` of envs match x to 2e-4 relative to the env's largest
  |x| (the humanoid's accelerations reach O(1e3), where f32 rounding alone
  exceeds an absolute 2e-4), and the mean gap of the two objectives,
  evaluated in f64, is under 2e-3 relative. Returns both numbers."""
  from mujoco_tpu_torch.ops import newton_cuda
  gap = (out_k[0] - out_p[0]).abs().amax(1)
  scale = torch.clamp(out_p[0].abs().amax(1), min=1.0)
  close = (gap < 2e-4 * scale).float().mean().item()
  args64 = [a.double() for a in args]
  c_k = newton_cuda.objective(args64, out_k[0].double())
  c_p = newton_cuda.objective(args64, out_p[0].double())
  rel = ((c_k - c_p) / torch.clamp(c_p.abs(), min=1.0)).mean().item()
  print(f"{tag}: {close:.4%} of envs match to 2e-4 rel (need "
        f"{need:.0%}), mean objective gap {rel:.3e} (limit 2e-3)",
        flush=True)
  if close < need or not abs(rel) < 2e-3:
    raise AssertionError(f"{tag}: kernel and plain version disagree")
  return dict(close_share=close, objective_gap=rel)


def newton_bound(args, it, ls) -> tuple:
  """The Newton kernel's bound on these inputs: (bound ms, by, dense bound
  ms, by, kept rows per env mean, most). The kernel solves over the kept
  rows only: it reads in full D, fl and the two masks; for the kept rows
  only J, aref and R; then M's lower triangle (symmetric), a_s, warm and
  reg; it writes x, qfrc, every row's force and stat (32 × 2). The dense
  count reads J, aref and R of every row."""
  from mujoco_tpu_torch.ops import newton_cuda
  nbatch, nefc, nv = args[0].shape
  item = args[0].element_size()
  kept = newton_cuda.kept_rows(args[2], args[5], args[4]).sum(1)
  kept_mean, kept_max = kept.double().mean().item(), int(kept.max().item())
  rest = (2 * nbatch * nefc + 2 * nefc + nbatch * nv * (nv + 1) // 2
          + 2 * nbatch * nv + nbatch + 2 * nbatch * nv + nbatch * nefc
          + nbatch * 64)
  nbytes = item * (rest + kept.sum().item() * (nv + 2))
  bound_ms, bound_by = bound(
      nbytes, nbatch * newton_flops(kept_mean, nv, it, ls), args[0].dtype)
  dense_ms, dense_by = bound(item * (rest + nbatch * nefc * (nv + 2)),
                             nbatch * newton_flops(nefc, nv, it, ls),
                             args[0].dtype)
  return bound_ms, bound_by, dense_ms, dense_by, kept_mean, kept_max


def phase_newton(report, details):
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import newton_cuda, solver
  worst64 = 0.0
  for dtype in (torch.float64, torch.float32):
    m = zoo.humanoid(dtype)
    args = solver.newton_args(m, humanoid_state(m, B, 2))
    active = int((args[2] > 0).sum().item())
    for iterations, ls_iter in ((1, 4), (4, 4)):
      out_k = newton_cuda.newton_kernel(*args, iterations, ls_iter)
      torch.cuda.synchronize()
      out_p = newton_cuda.newton_plain(*args, iterations, ls_iter)
      tag = f"newton {str(dtype)[6:]} it{iterations} ls{ls_iter}"
      if dtype == torch.float64:
        errs = {k: (a - b).abs().max().item() for k, a, b in zip(
            ("x", "force", "qfrc", "stat"), out_k, out_p)}
        viol = newton_violation(out_k, out_p)
        print(f"{tag}: {active} active rows, max abs err "
              + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + "; worst err / (1e-9 + 1e-9·|plain|) "
              + " ".join(f"{k} {v:.3f}" for k, v in viol.items()),
              flush=True)
        for k, v in viol.items():
          if not v <= 1.0:
            raise AssertionError(f"{tag}: {k} off by {v} × (1e-9 + "
                                 f"1e-9·|plain|)")
        worst64 = max(worst64, errs["x"])
      else:
        newton_f32_gate(tag, args, out_k, out_p,
                        0.99 if iterations == 1 else 0.85)
  # time at the main path's shape and type (f32, it 1, ls 4)
  it, ls = int(m.opt.iterations), int(m.opt.ls_iterations)
  kernel_ms = cuda_ms_cold(lambda: newton_cuda.newton_kernel(*args, it, ls))
  warm_ms = device_ms(lambda: newton_cuda.newton_kernel(*args, it, ls))
  plain_ms = cuda_ms_cold(lambda: newton_cuda.newton_plain(*args, it, ls),
                          reps=5)
  nefc, nv = args[0].shape[1:]
  bound_ms, bound_by, dense_ms, dense_by, kept_mean, kept_max = \
      newton_bound(args, it, ls)
  print(f"newton_pyramidal f32 B{B} nefc{nefc} nv{nv} it{it} ls{ls}: "
        f"kernel_ms {kernel_ms:.4f} (L2 flushed; L2-warm {warm_ms:.4f}) "
        f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by}; kept "
        f"rows per env mean {kept_mean:.2f}, most {kept_max}, of {nefc}) "
        f"beside the dense bound_ms {dense_ms:.5f} ({dense_by}; every row)",
        flush=True)
  # what sets the kernel's time: resident blocks per SM, and the time of
  # one block per SM (a single env's latency) against one full wave
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  occ = newton_cuda.occupancy(nefc, nv, torch.float32)
  per_sm = occ["blocks_per_sm"]
  if occ["threads"] != 32:
    raise AssertionError(f"the Newton kernel at nv {nv} runs {occ['threads']}"
                         f" threads per env, not one warp")
  waves = {}
  for k in (sms, sms * per_sm):
    sub = [a if i in (5, 6) else a[:k].contiguous()     # 5, 6: row masks
           for i, a in enumerate(args)]
    waves[k] = device_ms(lambda: newton_cuda.newton_kernel(*sub, it, ls))
  print(f"newton_pyramidal f32 occupancy: 32 threads per env, {per_sm} "
        f"blocks/SM on {sms} SMs "
        f"({-(-B // (sms * per_sm))} waves at B{B}); one block per SM "
        f"{waves[sms]:.4f} ms, one full wave ({sms * per_sm} envs) "
        f"{waves[sms * per_sm]:.4f} ms", flush=True)
  details["newton"] = dict(l2_warm_ms=warm_ms, blocks_per_sm=per_sm, sms=sms,
                           one_block_per_sm_ms=waves[sms],
                           one_wave_ms=waves[sms * per_sm],
                           kept_rows_mean=kept_mean, kept_rows_max=kept_max,
                           flops_per_env=newton_flops(kept_mean, nv, it, ls),
                           dense_bound_ms=dense_ms)
  report["newton_pyramidal"] = dict(
      name="newton_pyramidal", route="cuda",
      source="mujoco_tpu_torch/csrc/newton.cu",
      replaces="mujoco_tpu/ops/newton_tpu.py:155", max_abs_err=worst64,
      ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
      library_ms=None)


MEGASTEP_MODELS = ("humanoid", "quadruped", "mixed", "spherebox")
# the humanoid's megastep kernel_ms (f32, B 3072, 200 steps, L2 flushed)
# as measured before the wide routes joined its source, for comparison
NARROW_MS_BEFORE = 41.550
NARROW_MS_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def posed_state(m, nbatch, seed, lower=0.3):
  """The megastep STATE dict of a batch posed from a numpy seed: qpos0 plus
  0.05·N(0, 1), every free body lowered by up to ``lower`` (toward and into
  the floor), qvel 0.5·N(0, 1), ctrl 0.3·N(0, 1), and small qfrc_applied and
  xfrc_applied, on the card in the Model's dtype; plus the guard's fresh
  state (make_data's)."""
  from mujoco_tpu_torch.models import io
  rng = np.random.default_rng(seed)
  qpos = m.qpos0.cpu().double().numpy() + 0.05 * rng.standard_normal(
      (nbatch, m.nq))
  for j in range(m.njnt):
    if m.jnt_type[j] == 0:
      qpos[:, m.jnt_qposadr[j] + 2] -= rng.uniform(0.0, lower, nbatch)
  t = lambda a: torch.tensor(a, dtype=m.dtype, device="cuda").contiguous()
  state = dict(qpos=t(qpos), qvel=t(0.5 * rng.standard_normal((nbatch, m.nv))),
               ctrl=t(0.3 * rng.standard_normal((nbatch, m.nu))),
               warm=t(np.zeros((nbatch, m.nv))),
               qacc=t(np.zeros((nbatch, m.nv))), time=t(np.zeros(nbatch)),
               qfrc_applied=t(0.1 * rng.standard_normal((nbatch, m.nv))),
               xfrc=t(0.5 * rng.standard_normal((nbatch, 6 * m.nbody))))
  d0 = io.make_data(m)
  fresh = {k: getattr(d0, k)[0].contiguous() for k in ("qpos", "qvel",
                                                       "ctrl")}
  return state, fresh


def megastep_flops(m, active=None) -> float:
  """Arithmetic of one megastep step per env, counted from csrc/megastep.cu
  stage by stage (multiply-adds count 2): FK and frames ~250 per body,
  cinert ~250 per body, cdof ~30 per dof, CRB 36 per body, u 72 per dof,
  qM 24·nv², com_vel and cacc 4·6·nbody·nv plus cdof_dot 12·nv² + 30·nv,
  RNE and xfrc forces ~190 per body and 24·nbody·nv projections, the a_s
  LDL solve and, only where the tables set USE_DAMP, the damped Euler's
  (the humanoid disables eulerdamp), the narrowphase ~400 per group, the
  limit rows ~30 each, then per contact slot its Jacobian ~50 per dof and
  its velocity sums 6 per dof and its rows ~60, the Newton solve with its
  final Jᵀf (newton_flops), and Euler ~10 per dof. active = (rows, slots),
  the mean active constraint rows and contact slots per env-step that a
  timed run measured, counts the work these inputs need: the Newton solve
  over those rows, each active slot's Jacobian once. None gives the
  dense count: every row and slot, the Jacobian twice, as the dense kernel
  computed it."""
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  nb, nv, nefc = m.nbody, m.nv, m.efc.nefc
  ncon, nl = m.con.ncon, m.efc.nl
  if active is None:
    rows, slots, jac = nefc, ncon, 100
  else:
    (rows, slots), jac = active, 56
  ngroup = int(np.count_nonzero(m.con.con_first)) if ncon else 0
  nldl = 1 + bool(mc.tables(m).counts["flags"] & mc.USE_DAMP)
  flops = (500 * nb + 30 * nv + 36 * nb + 72 * nv + 24 * nv * nv
           + 24 * nb * nv + 12 * nv * nv + 30 * nv + 190 * nb
           + 24 * nb * nv + nldl * ldl_flops(nv) + 400 * ngroup + 30 * nl
           + slots * (jac * nv + 60) + 10 * nv)
  if nefc:
    flops += newton_flops(rows, nv, int(m.opt.iterations),
                          int(m.opt.ls_iterations))
  return flops


def f32_fractions(out_a, out_b) -> dict:
  """Per qpos and qvel, the share of envs whose largest |a − b| is below
  2e-4 of the env's largest |b| (at least 1): the Newton kernel's f32
  criterion."""
  fracs = {}
  for k in ("qpos", "qvel"):
    b = out_b[k].to(out_a[k].dtype)
    scale = torch.clamp(b.abs().amax(1), min=1.0)
    gap = (out_a[k] - b).abs().amax(1)
    fracs[k] = (gap < 2e-4 * scale).float().mean().item()
  return fracs


def check_f32(tag, out_k, out_p) -> dict:
  """Kernel against plain version at f32: ≥ 99 % of envs by f32_fractions
  on qpos and qvel (kinks: see PERF.md), or the phase fails."""
  fracs = f32_fractions(out_k, out_p)
  print(f"megastep f32 {tag}: envs within 2e-4 rel "
        + " ".join(f"{k} {v:.2%}" for k, v in fracs.items())
        + " (need 99%)", flush=True)
  if min(fracs.values()) < 0.99:
    raise AssertionError(f"megastep f32 {tag}: kernel and plain disagree")
  return fracs


def f32_floor_witness(m, nbatch) -> dict:
  """Printed, not a gate: why the f32 checks pose bodies at most 0.15 deep.
  At 0.3 deep, the kernel against the f32 plain version next to the f32
  plain version against the f64 plain version on the same (f32) inputs:
  if the second share is as low as the first, the gap is rounding that
  both f32 sides share, not something the kernel adds."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  m64 = zoo.humanoid(torch.float64)
  state, fresh = posed_state(m, nbatch, 3, lower=0.3)
  s64 = {k: v.double() for k, v in state.items()}
  f64 = {k: v.double() for k, v in fresh.items()}
  out = {}
  for nstep in (1, 10):
    k32 = mc.megastep_kernel(m, state, nstep, fresh)
    p32 = mc.megastep_plain(m, state, nstep, fresh)
    p64 = mc.megastep_plain(m64, s64, nstep, f64)
    out[nstep] = dict(kernel_vs_plain32=f32_fractions(k32, p32),
                      plain32_vs_plain64=f32_fractions(p32, p64),
                      kernel_vs_plain64=f32_fractions(k32, p64))
    print(f"megastep f32 floor, humanoid B{nbatch} sunk up to 0.3, {nstep} "
          f"steps, envs within 2e-4 rel (qpos, qvel): " + "; ".join(
              f"{tag} " + " ".join(f"{v:.2%}" for v in fr.values())
              for tag, fr in out[nstep].items()), flush=True)
  return out


def megastep_bytes(m, nbatch) -> int:
  """Bytes a megastep launch must move: the state read once and written
  once (qpos, qvel, ctrl, warm, qacc, time, qfrc_applied, xfrc in; the
  first six out) and the packed tables once."""
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  item = 8 if m.dtype == torch.float64 else 4
  nstate_in = m.nq + 4 * m.nv + m.nu + 1 + 6 * m.nbody
  nstate_out = m.nq + 3 * m.nv + m.nu + 1
  return item * nbatch * (nstate_in + nstate_out) + mc.packed(
      m, m.dtype, "cuda")[1].numel()


def occupancy(m) -> dict:
  """What sets the megastep's envs per SM for m's dtype on its route,
  printed: the untimed kernel's registers and local (spilled) bytes per
  thread, its dynamic shared memory per block, the device-memory work
  space per env (the wide route's), resident blocks per SM and the
  waves of a B-env launch."""
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  route = mc.route(m, m.dtype)
  attrs = mc.attributes(m.dtype, route_name=route)
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  item = 8 if m.dtype == torch.float64 else 4
  out = dict(attrs, route=route, smem_bytes=mc.smem_bytes(m, m.dtype),
             work_bytes_per_env=(mc.work_values_kernel(m, m.dtype) * item
                                 if route == "wide_device" else 0),
             blocks_per_sm=mc.blocks_per_sm(m, m.dtype), sms=sms)
  out["waves"] = B / (sms * out["blocks_per_sm"])
  print(f"megastep {str(m.dtype)[6:]} occupancy ({route} route"
        + (f", {out['work_bytes_per_env']} B of device memory per env"
           if out["work_bytes_per_env"] else "")
        + f"): {out['threads']} threads "
        f"per block, {out['regs']} registers and {out['local_bytes']} local "
        f"bytes per thread, {out['smem_bytes']} B dynamic shared memory per "
        f"block, {out['blocks_per_sm']} blocks/SM on {sms} SMs, "
        f"{out['waves']:.2f} waves at B{B}", flush=True)
  return out


def stage_clock(m, state, fresh, tag, nstep=NSTEP) -> dict:
  """One nstep launch of the kernel's stage-clock instantiation on state:
  each stage's share of the summed cycles and its µs per env-step (cycles
  at the card's SM clock), the mean and largest active constraint rows per
  env-step and the mean active contact slots, printed."""
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  _, stats = mc.megastep_timed(m, state, nstep, fresh)
  st = stats.double().cpu()
  nst = len(mc.STAGES)
  cycles = st[:, :nst].mean(0) / nstep                 # per env-step
  mhz = mc.sm_clock_khz() / 1e3
  us = cycles / mhz
  total = us.sum().item()
  out = dict(sm_clock_mhz=mhz, us_per_env_step=total,
             stages={name: dict(share=(us[i] / total).item(),
                                us_per_env_step=us[i].item())
                     for i, name in enumerate(mc.STAGES)},
             mean_active_rows=(st[:, nst].mean() / nstep).item(),
             max_active_rows=int(st[:, nst + 1].max().item()),
             mean_active_slots=(st[:, nst + 2].mean() / nstep).item(),
             timed_attributes=mc.attributes(
                 m.dtype, timed=True, route_name=mc.route(m, m.dtype)))
  print(f"megastep stage clock, {tag}, {str(m.dtype)[6:]} B"
        f"{state['qpos'].shape[0]} {nstep} steps: {total:.3f} µs per "
        f"env-step at {mhz:.0f} MHz; " + ", ".join(
            f"{k} {v['share']:.1%} {v['us_per_env_step']:.3f} µs"
            for k, v in out["stages"].items()), flush=True)
  print(f"megastep active rows per env-step, {tag}: mean "
        f"{out['mean_active_rows']:.2f}, most {out['max_active_rows']} (of "
        f"{m.efc.nefc}); active contact slots mean "
        f"{out['mean_active_slots']:.2f} (of {m.con.ncon})", flush=True)
  return out


def phase_stage_clock(details):
  """The stage clock at the main path's start (make_batch with 0.01·N(0, 1)
  qpos noise, humanoid, f32, B 3072, 200 steps)."""
  from mujoco_tpu_torch.models import io, zoo
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  m = zoo.humanoid(torch.float32)
  d = main_path_batch(m)
  # the guard's fresh state, as scan_batch makes it
  d0 = io.make_data(m)
  fresh = {k: getattr(d0, k)[0].contiguous() for k in ("qpos", "qvel",
                                                       "ctrl")}
  details["stage_clock_main_path"] = stage_clock(m, mc.state_of(d), fresh,
                                                 "main path's start")


def phase_megastep(report, details):
  """Kernel 3 against its plain version on the four snapshots, then its
  time at the main path's shape."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  nb_check = 512
  worst64 = 0.0
  for name in MEGASTEP_MODELS:
    m = zoo.load(name, torch.float64)
    assert mc.supported(m), name
    state, fresh = posed_state(m, nb_check, 7)
    # f64, one step: elementwise at the tolerances of the CPU tests
    out_k = mc.megastep_kernel(m, state, 1, fresh)
    torch.cuda.synchronize()
    out_p = mc.megastep_plain(m, state, 1, fresh)
    errs = {}
    for k, tol in (("qpos", 1e-9), ("qvel", 1e-8), ("qacc", 1e-6)):
      diff = (out_k[k] - out_p[k]).abs()
      errs[k] = diff.max().item()
      viol = (diff / (tol + tol * out_p[k].abs())).max().item()
      if not viol <= 1.0:
        raise AssertionError(f"megastep f64 {name} 1 step: {k} off by "
                             f"{viol} × ({tol} + {tol}·|plain|)")
    worst64 = max(worst64, errs["qpos"])
    # f64, 25 steps: finite, ≥ 99 % of envs with qpos within 1e-8
    out_k = mc.megastep_kernel(m, state, 25, fresh)
    out_p = mc.megastep_plain(m, state, 25, fresh)
    gap = (out_k["qpos"] - out_p["qpos"]).abs().amax(1)
    finite = bool(torch.isfinite(out_k["qpos"]).all()
                  & torch.isfinite(out_k["qvel"]).all())
    close25 = (gap <= 1e-8).float().mean().item()
    print(f"megastep f64 {name} B{nb_check}: 1 step max abs err "
          + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; 25 steps finite {finite}, {close25:.2%} of envs qpos within"
          f" 1e-8 (need 99%), largest qpos diff {gap.max().item():.3e}",
          flush=True)
    if not finite or close25 < 0.99:
      raise AssertionError(f"megastep f64 {name} 25 steps disagree")
    # f32, 1 and 10 steps: ≥ 99 % of envs within 2e-4 relative to the
    # env's largest |value| (kinks: see PERF.md). The poses sink at most
    # 0.15 here; f32_floor_witness shows what f32 rounding alone does to
    # both sides at 0.3
    m32 = zoo.load(name, torch.float32)
    s32, f32 = posed_state(m32, nb_check, 7, lower=0.15)
    for nstep in (1, 10):
      out_k = mc.megastep_kernel(m32, s32, nstep, f32)
      out_p = mc.megastep_plain(m32, s32, nstep, f32)
      check_f32(f"{name} B{nb_check} {nstep} steps", out_k, out_p)

  # the main path's shape: humanoid, f32, B 3072, posed as the f32 checks
  m = zoo.humanoid(torch.float32)
  state, fresh = posed_state(m, B, 3, lower=0.15)
  run = lambda: mc.megastep_kernel(m, state, NSTEP, fresh)
  kernel_ms = cuda_ms_cold(run, reps=5, warmup=1)
  warm_ms = cuda_ms(run, reps=5, warmup=1)
  held = {}

  def plain10():
    held["out"] = mc.megastep_plain(m, state, 10, fresh)

  plain_ms = cuda_ms(plain10, reps=1, warmup=1) / 10
  # the kernel at the batch the main path launches it with, against the
  # plain output just timed
  details["megastep_f32_b3072_10_steps"] = check_f32(
      f"humanoid B{B} 10 steps", mc.megastep_kernel(m, state, 10, fresh),
      held["out"])
  details["megastep_f32_depth_0.3"] = f32_floor_witness(m, B)
  # the bound: the state read once and written once (qpos, qvel, ctrl,
  # warm, qacc, time, qfrc_applied, xfrc in; the first six out) and the
  # packed tables once; the operations these inputs need, over the active
  # rows and slots that the timed kernel counts on them, with the dense
  # count beside
  clock = stage_clock(m, state, fresh, "timing inputs")
  active = (clock["mean_active_rows"], clock["mean_active_slots"])
  nbytes = megastep_bytes(m, B)
  bound_ms, bound_by = bound(nbytes, B * NSTEP * megastep_flops(m, active),
                             torch.float32)
  dense_ms, dense_by = bound(nbytes, B * NSTEP * megastep_flops(m),
                             torch.float32)
  occ = occupancy(m)
  sms, per_sm = occ["sms"], occ["blocks_per_sm"]
  waves = {}
  for k in (sms, sms * per_sm):
    sub = {n: v[:k].contiguous() for n, v in state.items()}
    waves[k] = cuda_ms(lambda: mc.megastep_kernel(m, sub, NSTEP, fresh),
                       reps=3, warmup=1)
  # the stage clock at one block per SM: each env's latency alone
  clock_one = stage_clock(m, {n: v[:sms].contiguous()
                              for n, v in state.items()}, fresh,
                          "timing inputs, one block per SM")
  print(f"megastep f32 B{B} {NSTEP} steps: kernel_ms {kernel_ms:.3f} (L2 "
        f"flushed; L2-warm {warm_ms:.3f}; {NARROW_MS_BEFORE} before the "
        f"wide routes were added, {NARROW_MS_CARD}) plain_ms {plain_ms:.3f} per step "
        f"bound_ms {bound_ms:.4f} ({bound_by}; "
        f"{megastep_flops(m, active):.0f} operations per env-step over "
        f"{active[0]:.2f} active rows and {active[1]:.2f} active slots) "
        f"beside the dense bound_ms {dense_ms:.4f} ({dense_by}; "
        f"{megastep_flops(m):.0f} per env-step over {m.efc.nefc} rows); one "
        f"block per SM {waves[sms]:.3f} ms, one full wave "
        f"({sms * per_sm} envs) {waves[sms * per_sm]:.3f} ms", flush=True)
  # the kernel at f64 once, L2-warm (posed as the f64 checks)
  m64 = zoo.humanoid(torch.float64)
  s64, f64 = posed_state(m64, B, 3)
  f64_ms = cuda_ms(lambda: mc.megastep_kernel(m64, s64, NSTEP, f64), reps=2,
                   warmup=1)
  occ64 = occupancy(m64)
  print(f"megastep f64 B{B} {NSTEP} steps: kernel_ms {f64_ms:.3f} "
        f"(L2-warm), {occ64['smem_bytes']} B shared memory, "
        f"{occ64['regs']} registers, {occ64['blocks_per_sm']} blocks/SM",
        flush=True)
  details["megastep"] = dict(l2_warm_ms=warm_ms, plain_ms_per_step=plain_ms,
                             occupancy=occ, one_block_per_sm_ms=waves[sms],
                             one_wave_ms=waves[sms * per_sm],
                             flops_per_env_step=megastep_flops(m, active),
                             dense_flops_per_env_step=megastep_flops(m),
                             dense_bound_ms=dense_ms, stage_clock=clock,
                             stage_clock_one_block_per_sm=clock_one,
                             f64_ms=f64_ms, f64_occupancy=occ64)
  report["megastep"] = dict(
      name="megastep", route="cuda", source="mujoco_tpu_torch/csrc/megastep.cu",
      replaces="mujoco_tpu/ops/megastep_tpu.py:1389", max_abs_err=worst64,
      ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
      library_ms=None)


def main_path_batch(m):
  """make_batch with 0.01·N(0, 1) qpos noise, the main path's start."""
  from mujoco_tpu_torch.parallel import rollout
  d = rollout.make_batch(m, B)
  gen = torch.Generator(device="cuda").manual_seed(0)
  return d.replace(qpos=d.qpos + 0.01 * torch.randn(
      d.qpos.shape, generator=gen, device="cuda", dtype=d.qpos.dtype))


def reset_counts():
  from mujoco_tpu_torch.ops import linalg_cuda, megastep_cuda, newton_cuda
  linalg_cuda.LAUNCHES = newton_cuda.LAUNCHES = megastep_cuda.LAUNCHES = 0


def read_counts() -> dict:
  from mujoco_tpu_torch.ops import linalg_cuda, megastep_cuda, newton_cuda
  return {"ldl_solve": linalg_cuda.LAUNCHES,
          "newton_pyramidal": newton_cuda.LAUNCHES,
          "megastep": megastep_cuda.LAUNCHES}


class stage_path:
  """MJTPU_MEGASTEP=0 inside the block: scan_steps takes the stage path."""

  def __enter__(self):
    self.old = os.environ.get("MJTPU_MEGASTEP")
    os.environ["MJTPU_MEGASTEP"] = "0"

  def __exit__(self, *exc):
    if self.old is None:
      os.environ.pop("MJTPU_MEGASTEP")
    else:
      os.environ["MJTPU_MEGASTEP"] = self.old


def phase_main_path(report, details):
  """The main path: one rollout.scan_steps call, through the megastep."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.parallel import rollout
  m = zoo.humanoid(torch.float32)
  d = main_path_batch(m)
  torch.cuda.synchronize()
  reset_counts()
  t0 = time.perf_counter()
  out = rollout.scan_steps(m, d, NSTEP, check=True)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = read_counts()
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  sps = B * NSTEP / wall
  print(f"main path: humanoid f32 B{B} {NSTEP} steps check=True: wall "
        f"{wall:.4f} s, {sps:.1f} env-steps/s, launches {launches}, "
        f"finite {finite}", flush=True)
  if not finite:
    raise AssertionError("main path produced a non-finite state")
  if launches != {"ldl_solve": 0, "newton_pyramidal": 0, "megastep": 1}:
    raise AssertionError(f"main path launches {launches}: want one megastep "
                         f"launch and no other")
  report["megastep"]["launches"] = launches["megastep"]
  # a second call with the tables cached
  t0 = time.perf_counter()
  rollout.scan_steps(m, d, NSTEP, check=True)
  torch.cuda.synchronize()
  wall2 = time.perf_counter() - t0
  print(f"main path, second call: wall {wall2:.4f} s, "
        f"{B * NSTEP / wall2:.1f} env-steps/s", flush=True)
  details["main_path"] = dict(batch=B, nstep=NSTEP, wall_s=wall,
                              env_steps_per_s=sps, second_wall_s=wall2,
                              second_env_steps_per_s=B * NSTEP / wall2,
                              launches=launches,
                              mean_height=out.qpos[:, 2].mean().item())


def phase_stage_path(report, details, nstep=20):
  """The stage path (MJTPU_MEGASTEP=0) at a cut depth: one LDL and one
  Newton launch per step, a finite state."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.parallel import rollout
  m = zoo.humanoid(torch.float32)
  d = main_path_batch(m)
  torch.cuda.synchronize()
  with stage_path():
    reset_counts()
    t0 = time.perf_counter()
    out = rollout.scan_steps(m, d, nstep, check=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  sps = B * nstep / wall
  print(f"stage path (MJTPU_MEGASTEP=0): humanoid f32 B{B} {nstep} steps: "
        f"wall {wall:.3f} s, {sps:.1f} env-steps/s, launches {launches}, "
        f"finite {finite}", flush=True)
  if not finite:
    raise AssertionError("stage path produced a non-finite state")
  if launches != {"ldl_solve": nstep, "newton_pyramidal": nstep,
                  "megastep": 0}:
    raise AssertionError(f"stage path launches {launches} in {nstep} steps")
  for name in ("ldl_solve", "newton_pyramidal"):
    report[name]["launches"] = launches[name]
    report[name].setdefault("launches_by_path", {})["stage_path"] = \
        launches[name]
  details["stage_path"] = dict(batch=B, nstep=nstep, wall_s=wall,
                               env_steps_per_s=sps, launches=launches)


def profile_window(fn, nstep):
  """Wall, device busy time and the kernels of fn() under torch.profiler
  (CUDA activity), per step; fn ends in a synchronize."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
    t0 = time.perf_counter()
    fn()
    wall_ms = (time.perf_counter() - t0) * 1e3 / nstep
  kernels = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  if not kernels:
    raise AssertionError("the profiler recorded no device kernel")
  by_name = {}
  for e in kernels:
    t, n = by_name.get(e.name, (0.0, 0))
    by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
  busy_ms = sum(t for t, _ in by_name.values()) / 1e3 / nstep
  top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
  return dict(wall_ms_per_step=wall_ms, device_busy_ms_per_step=busy_ms,
              device_idle_share=1 - busy_ms / wall_ms,
              kernel_launches_per_step=len(kernels) / nstep,
              top=[dict(name=name[:100], ms_per_step=t / 1e3 / nstep,
                        launches_per_step=n / nstep)
                   for name, (t, n) in top]), by_name


def phase_profile(details, nstep=10):
  """Where the time goes: a window of the megastep path (one 200-step
  scan_steps call) and one of the stage path (nstep warm steps), each with
  wall, device busy time and idle share from that window, and the same
  work unprofiled for the tracing's cost."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.parallel import rollout
  m = zoo.humanoid(torch.float32)
  d = main_path_batch(m)

  def mega():
    rollout.scan_steps(m, d, NSTEP, check=True)
    torch.cuda.synchronize()

  mega()
  t0 = time.perf_counter()
  mega()
  plain_wall = (time.perf_counter() - t0) * 1e3 / NSTEP
  out, by_name = profile_window(mega, NSTEP)
  out["unprofiled_wall_ms_per_step"] = plain_wall
  out["megastep_kernel_ms_per_step"] = sum(
      t for name, (t, _) in by_name.items() if "megastep_kernel" in name
  ) / 1e3 / NSTEP
  details["profile_megastep"] = out
  print(f"profile, megastep path: humanoid f32 B{B} one {NSTEP}-step call: "
        f"wall {out['wall_ms_per_step']:.4f} ms/step (unprofiled "
        f"{plain_wall:.4f}), device busy {out['device_busy_ms_per_step']:.4f}"
        f" ms/step, idle {out['device_idle_share']:.2%}, "
        f"{out['kernel_launches_per_step'] * NSTEP:.0f} kernel launches in "
        f"the call, the megastep kernel "
        f"{out['megastep_kernel_ms_per_step']:.4f} ms/step", flush=True)

  with stage_path():
    d = rollout.scan_steps(m, d, 20, check=True)   # warm up, reach contact

    def stage():
      rollout.scan_steps(m, d, nstep, check=True)
      torch.cuda.synchronize()

    t0 = time.perf_counter()
    stage()
    plain_wall = (time.perf_counter() - t0) * 1e3 / nstep
    out, by_name = profile_window(stage, nstep)
  out["unprofiled_wall_ms_per_step"] = plain_wall
  out["handwritten_kernels_ms_per_step"] = sum(
      t for name, (t, _) in by_name.items()
      if any(k in name for k in HANDWRITTEN)) / 1e3 / nstep
  details["profile_stage"] = out
  print(f"profile, stage path: humanoid f32 B{B} {nstep} warm steps: wall "
        f"{out['wall_ms_per_step']:.3f} ms/step (unprofiled {plain_wall:.3f})"
        f", device busy {out['device_busy_ms_per_step']:.3f} ms/step, idle "
        f"{out['device_idle_share']:.2%}, "
        f"{out['kernel_launches_per_step']:.1f} kernel launches/step, the "
        f"LDL and Newton kernels {out['handwritten_kernels_ms_per_step']:.3f}"
        f" ms/step", flush=True)


def phase_cross_check(details):
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.parallel import rollout
  outs = {}
  for dev in ("cuda", "cpu"):
    m = zoo.humanoid(torch.float64, device=dev)
    d = rollout.make_batch(m, 64, device=dev)
    noise = torch.from_numpy(
        np.random.default_rng(5).standard_normal(tuple(d.qpos.shape)))
    d = d.replace(qpos=d.qpos + 0.02 * noise.to(dev))
    outs[dev] = rollout.scan_steps(m, d, 25, check=True).qpos.cpu()
  err = (outs["cuda"] - outs["cpu"]).abs().max().item()
  print(f"cross-check: 25 steps f64 B64, card vs CPU max qpos err "
        f"{err:.3e} (limit 1e-8)", flush=True)
  details["cross_check_qpos_err"] = err
  if not err <= 1e-8:
    raise AssertionError(f"card and CPU trajectories differ by {err}")


GENERAL_NSTEP = 10


def run_steps(m, d, nstep):
  """scan_steps(check=True) one step at a time: the same state, plus each
  step's Newton iteration counts (B, nstep), read back at the end."""
  from mujoco_tpu_torch.models import io
  from mujoco_tpu_torch.ops import forward
  from mujoco_tpu_torch.parallel import rollout
  fresh = io.make_data(m, dtype=d.qpos.dtype, device=d.qpos.device)
  niters = []
  for _ in range(nstep):
    d = rollout.check_reset(m, forward.step(m, d), fresh)
    niters.append(d.solver_niter)
  return d, torch.stack(niters, dim=1).cpu()


def general_batch(m, nbatch, seed, device="cuda"):
  """A batch of m posed from a numpy seed: qpos0 + 0.05·N(0, 1), qvel
  0.3·N(0, 1) (as tests/test_torch_general.py poses its scenes)."""
  from mujoco_tpu_torch.parallel import rollout
  d = rollout.make_batch(m, nbatch, device=device)
  rng = np.random.default_rng(seed)
  t = lambda a: torch.tensor(a, dtype=m.dtype, device=device)
  return d.replace(
      qpos=d.qpos + t(0.05 * rng.standard_normal(tuple(d.qpos.shape))),
      qvel=t(0.3 * rng.standard_normal(tuple(d.qvel.shape))))


def card_vs_cpu(load, make, nstep, tag) -> float:
  """nstep steps at f64 of make(m, device) on the card and on the CPU;
  fails unless qpos and qvel agree to 1e-8 + 1e-8·|CPU|. Returns the
  largest violation ratio."""
  outs = {}
  for dev in ("cuda", "cpu"):
    m = load(torch.float64, dev)
    d, niters = run_steps(m, make(m, dev), nstep)
    outs[dev] = (d.qpos.cpu(), d.qvel.cpu(), niters)
  worst = 0.0
  for i, k in enumerate(("qpos", "qvel")):
    a, b = outs["cuda"][i], outs["cpu"][i]
    worst = max(worst, ((a - b).abs() / (1e-8 + 1e-8 * b.abs())).max().item())
  same_niter = bool((outs["cuda"][2] == outs["cpu"][2]).all())
  print(f"{tag}: {nstep} steps f64 B{outs['cpu'][0].shape[0]}, card vs CPU "
        f"worst err / (1e-8 + 1e-8·|CPU|) {worst:.3f}, Newton iteration "
        f"counts identical {same_niter}", flush=True)
  if not worst <= 1.0:
    raise AssertionError(f"{tag}: card and CPU differ ({worst} × limit)")
  return worst


def phase_general_core(report, details):
  """(a) the general core at full width on the humanoid at MuJoCo's default
  solver options."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import megastep_cuda
  from mujoco_tpu_torch.parallel import rollout
  load = lambda dtype, dev="cuda": zoo.load(
      "humanoid", dtype, dev, opt=zoo.MUJOCO_DEFAULT_SOLVER)
  m = load(torch.float32)
  if megastep_cuda.supported(m):
    raise AssertionError("the megastep admits the humanoid at 100 iterations")
  d = main_path_batch(m)
  torch.cuda.synchronize()
  reset_counts()
  t0 = time.perf_counter()
  out = rollout.scan_steps(m, d, GENERAL_NSTEP, check=True)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = read_counts()
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  sps = B * GENERAL_NSTEP / wall
  print(f"general core: humanoid at MuJoCo's default solver options f32 B{B} "
        f"{GENERAL_NSTEP} steps check=True: wall {wall:.3f} s, {sps:.1f} "
        f"env-steps/s, launches {launches}, LDL launches per step "
        f"{launches['ldl_solve'] / GENERAL_NSTEP:.1f}, finite {finite}",
        flush=True)
  if not finite:
    raise AssertionError("general core produced a non-finite state")
  if launches["newton_pyramidal"] or launches["megastep"] or \
      launches["ldl_solve"] < 2 * GENERAL_NSTEP:
    raise AssertionError(f"general core launches {launches}")
  # the same steps one at a time, with each step's Newton iteration counts
  reset_counts()
  _, niters = run_steps(m, d, GENERAL_NSTEP)
  torch.cuda.synchronize()
  counted = read_counts()
  most_per_step = niters.max(0).values
  need = GENERAL_NSTEP + int(most_per_step.sum())
  mean_it = niters.double().mean().item()
  print(f"general core Newton iterations per env-step: mean {mean_it:.3f}, "
        f"most {int(niters.max())}; LDL launches {counted['ldl_solve']} in "
        f"{GENERAL_NSTEP} steps (need ≥ {need}: one per step for qacc_smooth"
        f" and one per iteration of the env that iterates most)", flush=True)
  if counted["ldl_solve"] < need or counted["newton_pyramidal"]:
    raise AssertionError(f"general core launches {counted}, need {need} LDL")

  def window():
    rollout.scan_steps(m, d, 3, check=True)
    torch.cuda.synchronize()

  window()
  prof, _ = profile_window(window, 3)
  print(f"profile, general core: humanoid f32 B{B} 3 steps: wall "
        f"{prof['wall_ms_per_step']:.2f} ms/step, device busy "
        f"{prof['device_busy_ms_per_step']:.2f} ms/step, idle "
        f"{prof['device_idle_share']:.2%}, "
        f"{prof['kernel_launches_per_step']:.0f} kernel launches/step",
        flush=True)
  worst = card_vs_cpu(load, lambda mm, dev: general_batch(mm, 8, 11, dev), 5,
                      "general core humanoid")
  details["general_core"] = dict(
      batch=B, nstep=GENERAL_NSTEP, wall_s=wall, env_steps_per_s=sps,
      launches=launches, ldl_launches_per_step=launches["ldl_solve"]
      / GENERAL_NSTEP, newton_iterations_mean=mean_it,
      newton_iterations_most=int(niters.max()),
      most_per_step=most_per_step.tolist(), profile=prof,
      card_vs_cpu_worst=worst)
  report["ldl_solve"].setdefault("launches_by_path", {})[
      "general_core"] = launches["ldl_solve"]


# steps of phase 10's full-width run, cut from 50 to keep the script near
# 600 s beside phases 19-21; its gate still asks for at least two LDL
# launches a step (qacc_smooth and a Newton iteration)
# cut from 10 when phase 28 came, to keep the script in its time
MODEL_CLASS_NSTEP = 5


def phase_model_class(report, details):
  """(b) each scene of the general constraint class on the stage path."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.parallel import rollout
  out_details, total = {}, 0
  for name in zoo.GENERAL:
    m = zoo.load(name, torch.float32)
    d = general_batch(m, B, 0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = rollout.scan_steps(m, d, MODEL_CLASS_NSTEP, check=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    finite = bool(torch.isfinite(out.qpos).all()
                  & torch.isfinite(out.qvel).all())
    sps = B * MODEL_CLASS_NSTEP / wall
    print(f"model class {name}: nefc {m.efc.nefc} (ne {m.efc.ne}, nf "
          f"{m.efc.nf}, nl {m.efc.nl}), f32 B{B} {MODEL_CLASS_NSTEP} steps: "
          f"wall {wall:.3f} s, {sps:.1f} env-steps/s, launches {launches}, "
          f"finite {finite}", flush=True)
    if not finite or launches["newton_pyramidal"] or launches["megastep"] \
        or launches["ldl_solve"] < 2 * MODEL_CLASS_NSTEP:
      raise AssertionError(f"model class {name}: finite {finite}, "
                           f"launches {launches}")
    total += launches["ldl_solve"]
    worst = card_vs_cpu(lambda dtype, dev, n=name: zoo.load(n, dtype, dev),
                        lambda mm, dev: general_batch(mm, 64, 1, dev), 10,
                        f"model class {name}")
    out_details[name] = dict(wall_s=wall, env_steps_per_s=sps,
                             nstep=MODEL_CLASS_NSTEP, launches=launches,
                             card_vs_cpu_worst=worst)
  details["model_class"] = out_details
  report["ldl_solve"].setdefault("launches_by_path", {})[
      "model_class"] = total


NEWTON_COPIES = 512


def newton_env_violation(out_a, out_b):
  """Per env, the largest |a − b| / (1e-9 + 1e-9·|b|) over x, force, qfrc
  and stat (stat scaled by its row's |improvement| + |cost|)."""
  viol = torch.zeros(out_b[0].shape[0], dtype=torch.float64,
                     device=out_b[0].device)
  for name, a, b in zip(("x", "force", "qfrc", "stat"), out_a, out_b):
    scale = b.abs()
    if name == "stat":
      scale = scale.sum(-1, keepdim=True)
    v = (a - b).abs() / (1e-9 + 1e-9 * scale)
    viol = torch.maximum(viol, v.reshape(v.shape[0], -1).amax(1))
  return viol


def newton_rows_gate(args, out_k, out_p, iterations, ls, ncopy=NEWTON_COPIES):
  """Kernel against plain version at f64 on one scene's rows. Every env
  must match elementwise, 1e-9 + 1e-9·|plain| on x, force, qfrc and stat,
  but one where the plain version's own result is decided by the last bit
  (a linesearch that stops on a kink of the cost; ROADMAP §C). Such an env
  passes only if the plain version, rerun on ncopy copies of that env's own
  input moved at the last bit (J, aref and M by 1e-15 relative, M kept
  symmetric; every other copy with its rows in a random order), gives the
  kernel's result on at least one copy, elementwise to the same tolerance.
  At most B/100 envs may be off elementwise. Returns (off envs, worst
  violation on the others, one row per off env: [env, copies that give the
  kernel's result, the kernel's and the plain version's cost after each
  iteration, the lowest and highest final cost of the copies])."""
  from mujoco_tpu_torch.ops import newton_cuda
  dev = args[0].device
  viol = newton_env_violation(out_k, out_p)
  off = (viol > 1).nonzero()[:, 0]
  worst = viol[viol <= 1].max().item() if bool((viol <= 1).any()) else 0.0
  if len(off) == 0 or len(off) > viol.shape[0] // 100:
    return off.tolist(), worst, []

  gen = torch.Generator(device=dev).manual_seed(0)
  J, aref, D, R, fl, fric, ones, M, a_s, warm, reg = args
  n, nefc, nv = len(off), J.shape[1], J.shape[2]
  rep = lambda t: t[off].repeat_interleave(ncopy, 0)
  noise = lambda t: t * (1 + 1e-15 * torch.randn(
      t.shape, generator=gen, device=dev, dtype=t.dtype))
  order = torch.rand((n * ncopy, nefc), generator=gen, device=dev).argsort(1)
  order[0::2] = torch.arange(nefc, device=dev)
  rows = lambda t: t.gather(1, order)
  mm = noise(rep(M))
  copies = (noise(rep(J)).gather(1, order[..., None].expand(-1, -1, nv)),
            rows(noise(rep(aref))), rows(rep(D)), rows(rep(R)),
            rows(rep(fl)), rows(fric.expand(n * ncopy, nefc)),
            rows(ones.expand(n * ncopy, nefc)),
            0.5 * (mm + mm.transpose(1, 2)), rep(a_s), rep(warm), rep(reg))
  x, force, qfrc, stat = newton_cuda.newton_plain(*copies, iterations, ls)
  out_c = (x, torch.zeros_like(force).scatter(1, order, force), qfrc, stat)
  same = newton_env_violation([t.repeat_interleave(ncopy, 0) for t in (
      o[off] for o in out_k)], out_c).reshape(n, ncopy) <= 1
  cost_c = stat[:, iterations - 1, 1].reshape(n, ncopy)
  table = [[e, c, k, p, lo, hi] for e, c, k, p, lo, hi in zip(
      off.tolist(), same.sum(1).tolist(),
      out_k[3][off, :iterations, 1].tolist(),
      out_p[3][off, :iterations, 1].tolist(), cost_c.amin(1).tolist(),
      cost_c.amax(1).tolist())]
  return off.tolist(), worst, table


def phase_newton_rows(report, details):
  """(c) the Newton kernel on each scene's rows, then on the path."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward, newton_cuda, solver
  from mujoco_tpu_torch.parallel import rollout
  out_details, total = {}, 0
  for name in zoo.GENERAL:
    m = zoo.load(name, torch.float64)
    d = general_batch(m, B, 2)
    d = forward.fwd_acceleration(m, forward.fwd_actuation(
        m, forward.fwd_velocity(m, forward.fwd_position(m, d))))
    args = solver.newton_args(m, d.replace(
        qacc_warmstart=0.9 * d.qacc_smooth))
    ls = int(m.opt.ls_iterations)
    out_k = newton_cuda.newton_kernel(*args, 4, ls)
    torch.cuda.synchronize()
    out_p = newton_cuda.newton_plain(*args, 4, ls)
    viol = newton_violation(out_k, out_p)
    kept = newton_cuda.kept_rows(args[2], args[5], args[4])
    ne, nf = m.efc.ne, m.efc.nf
    kept_eq = kept[:, :ne].sum(1).double().mean().item()
    kept_fric = kept[:, ne:ne + nf].sum(1).double().mean().item()
    off, worst, table = newton_rows_gate(args, out_k, out_p, 4, ls)
    unmatched = [row for row in table if row[1] == 0]
    print(f"newton rows {name}: ne {ne}, nf {nf}, nefc {m.efc.nefc}; kept "
          f"rows per env mean {kept.sum(1).double().mean().item():.2f} "
          f"(equality {kept_eq:.2f}, friction loss {kept_fric:.2f}), most "
          f"{int(kept.sum(1).max())}; f64 B{B} it4 ls{ls} worst err / (1e-9 "
          f"+ 1e-9·|plain|) " + " ".join(f"{k} {v:.3f}"
                                          for k, v in viol.items())
          + f"; {len(off)} envs off elementwise (limit {B // 100}), worst "
          f"err / limit on the others {worst:.3f}; per off env [env, copies "
          f"of {NEWTON_COPIES} that give the kernel's result, kernel costs per "
          f"iteration, plain costs, copies' lowest and highest final cost] "
          f"{table}; off envs no copy reproduces {len(unmatched)}",
          flush=True)
    if len(off) > B // 100 or not worst <= 1.0 or unmatched:
      raise AssertionError(f"newton rows {name}: kernel and plain disagree")
    m4 = zoo.load(name, torch.float32, opt={"iterations": 4})
    d4 = general_batch(m4, B, 2)
    torch.cuda.synchronize()
    reset_counts()
    out = rollout.scan_steps(m4, d4, 5, check=True)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"newton rows {name} on the path: iterations 4, f32 B{B} 5 steps, "
          f"launches {launches}", flush=True)
    if launches["newton_pyramidal"] != 5 or launches["megastep"] or not bool(
        torch.isfinite(out.qpos).all()):
      raise AssertionError(f"newton rows {name}: launches {launches}")
    total += launches["newton_pyramidal"]
    out_details[name] = dict(ne=ne, nf=nf, kept_mean=kept.sum(1).double()
                             .mean().item(), kept_eq_mean=kept_eq,
                             kept_fric_mean=kept_fric, violation=viol,
                             off_envs=off, violation_other_envs=worst,
                             off_env_paths=table,
                             path_launches=launches)
  details["newton_rows"] = out_details
  report["newton_pyramidal"].setdefault("launches_by_path", {})[
      "general_scenes_iterations_4"] = total


def phase_ldl_backward(report, details):
  """(d) SpdSolve's backward through the kernel against the same backward
  through the plain version: λ = H⁻¹ p̄ re-solved, ḡ = λ, H̄ = −λ pᵀ."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import linalg_cuda
  d = humanoid_state(zoo.humanoid(torch.float64), B, 4)
  h, g = d.qM.contiguous(), d.qfrc_smooth.contiguous()
  w = torch.tensor(np.random.default_rng(9).standard_normal(tuple(g.shape)),
                   dtype=torch.float64, device="cuda")
  H, G = h.clone().requires_grad_(), g.clone().requires_grad_()
  before = linalg_cuda.LAUNCHES
  p = linalg_cuda.spd_solve(H, G)
  grads = torch.autograd.grad(p, (H, G), grad_outputs=w, retain_graph=True)
  torch.cuda.synchronize()
  launches = linalg_cuda.LAUNCHES - before
  p_plain = linalg_cuda.spd_solve_plain(h, g)

  def plain_backward():
    lam = linalg_cuda.spd_solve_plain(h, w)
    return -lam[:, :, None] * p_plain[:, None, :], lam

  rel = max(((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(grads, plain_backward()))
  # the same warmed timer for both: events around back-to-back calls of
  # the backward alone (p and the graph are kept from the forward)
  kernel_backward = lambda: torch.autograd.grad(
      p, (H, G), grad_outputs=w, retain_graph=True)
  kernel_ms = cuda_ms(kernel_backward)
  plain_ms = cuda_ms(plain_backward)
  print(f"ldl backward f64 B{B} n{h.shape[1]}: kernel launches {launches} "
        f"(forward and backward re-solve); max rel err of dH, dg against "
        f"the plain backward {rel:.3e} (limit 1e-9); backward alone "
        f"(re-solve and outer product), events around 30 warmed calls: "
        f"ms kernel path {kernel_ms:.4f}, plain path {plain_ms:.4f}",
        flush=True)
  if launches != 2 or not rel <= 1e-9:
    raise AssertionError(f"ldl backward: launches {launches}, rel err {rel}")
  details["ldl_backward"] = dict(rel_err=rel, kernel_backward_ms=kernel_ms,
                                 plain_backward_ms=plain_ms,
                                 launches=launches)


# cut from 20 when phase 28 came, to keep the script in its time
SLICE_NSTEP = 10
# orders of phase 13's wide LDL table, timed at f32 and f64 (n 270 is
# multi_humanoid10's qM; phase 19 times that solve on its mass matrices)
WIDE_ORDERS = (65, 81, 130, 200, 270)


def stage_run(m, d, nstep):
  """nstep steps of rollout.scan_steps(check=True) with the launch counts
  zeroed just before and read just after; returns (out, wall s,
  launches)."""
  from mujoco_tpu_torch.parallel import rollout
  torch.cuda.synchronize()
  reset_counts()
  t0 = time.perf_counter()
  out = rollout.scan_steps(m, d, nstep, check=True)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  return out, wall, read_counts()


def wide_ldl_case(n, dtype, seed):
  """B SPD matrices of order n made on the card from a seed, and g."""
  gen = torch.Generator(device="cuda").manual_seed(seed)
  a = torch.randn((B, n, n), generator=gen, device="cuda", dtype=dtype)
  h = a @ a.transpose(1, 2) + n * torch.eye(n, device="cuda", dtype=dtype)
  g = torch.randn((B, n), generator=gen, device="cuda", dtype=dtype)
  return h.contiguous(), g


def time_ldl(h, g, reps=30):
  """(L2-flushed ms, L2-warm ms, plain ms, torch.linalg.solve ms, bound ms,
  by) of the LDL kernel on (h, g). The wide route's launches take 0.6 ms
  and more, far above the wrapper's host time, so events around
  back-to-back calls time the kernel itself; late in a long run the
  profiler has missed a third of such a window's launches (18 and 19 of
  30, in two runs), so these times do not use it."""
  from mujoco_tpu_torch.ops import linalg_cuda
  bound_ms, by = ldl_bound(h.shape[0], h.shape[1], h.dtype)
  return (cuda_ms_cold(lambda: linalg_cuda.spd_solve_kernel(h, g), reps),
          cuda_ms(lambda: linalg_cuda.spd_solve_kernel(h, g), reps),
          cuda_ms_cold(lambda: linalg_cuda.spd_solve_plain(h, g), reps),
          cuda_ms_cold(lambda: torch.linalg.solve(h, g), reps), bound_ms, by)


def wide_ldl_row(tag, h, g):
  """The LDL kernel on (h, g) against its plain version (f64 elementwise,
  1e-9 + 1e-9·|plain|; f32 by ldl_gate's backward error), then timed
  beside torch.linalg.solve and its bound, with its route, threads, envs
  per block and blocks per SM; printed and returned."""
  from mujoco_tpu_torch.ops import linalg_cuda
  n = h.shape[1]
  if h.dtype == torch.float64:
    p = linalg_cuda.spd_solve_kernel(h, g)
    ref = linalg_cuda.spd_solve_plain(h, g)
    gate = ((p - ref).abs() / (1e-9 + 1e-9 * ref.abs())).max().item()
    err = (p - ref).abs().max().item()
    del p, ref
    if not gate <= 1.0:
      raise AssertionError(f"wide ldl {tag} disagrees with its plain "
                           f"version: {gate} of the limit")
  else:
    err = ldl_gate(f"wide ldl {tag}", h, g)
    gate = None
  k_ms, w_ms, p_ms, lib_ms, b_ms, by = time_ldl(h, g, 30 if n < 200 else 10)
  occ = linalg_cuda.occupancy(n, h.dtype)
  row = dict(n=n, dtype=str(h.dtype)[6:], ms=k_ms, l2_warm_ms=w_ms,
             plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=by,
             max_abs_err=err, gate_f64=gate, **occ)
  print(f"wide ldl {tag} B{h.shape[0]}: kernel_ms {k_ms:.4f} (L2 flushed; "
        f"L2-warm {w_ms:.4f}) library_ms {lib_ms:.4f} (torch.linalg.solve; "
        f"kernel / library {k_ms / lib_ms:.3f}) plain_ms {p_ms:.4f} "
        f"bound_ms {b_ms:.5f} ({by}); route {occ['route']}, "
        f"{occ['threads']} threads, {occ['envs_per_block']} envs per block, "
        f"{occ['blocks_per_sm']} blocks/SM"
        + ("" if gate is None else f"; worst err / (1e-9 + 1e-9·|plain|) "
           f"{gate:.3e}"), flush=True)
  return row


def phase_multi_humanoid(report, details):
  """13: multi_humanoid3 (nv 81) on the stage path (MJTPU_MEGASTEP=0; the
  megastep admits it, phase 29), the wide LDL and Newton routes against
  their plain versions, and their times."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import linalg_cuda, megastep_cuda, newton_cuda
  from mujoco_tpu_torch.ops import solver
  load = lambda dtype, dev="cuda": zoo.load("multi_humanoid3", dtype, dev)
  m = load(torch.float32)
  if not megastep_cuda.supported(m):
    raise AssertionError("the megastep refuses multi_humanoid3 (nv 81)")
  with stage_path():
    out, wall, launches = stage_run(m, main_path_batch(m), SLICE_NSTEP)
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  sps = B * SLICE_NSTEP / wall
  print(f"multi_humanoid3 (nv {m.nv}, nefc {m.efc.nefc}) on the stage path: "
        f"f32 B{B} {SLICE_NSTEP} steps: wall {wall:.3f} s, {sps:.1f} env-steps/s, "
        f"launches {launches}, finite {finite}", flush=True)
  if not finite or launches != {"ldl_solve": SLICE_NSTEP, "newton_pyramidal":
                                SLICE_NSTEP, "megastep": 0}:
    raise AssertionError(f"multi_humanoid3: finite {finite}, launches "
                         f"{launches}")
  for name in ("ldl_solve", "newton_pyramidal"):
    report[name].setdefault("launches_by_path", {})["multi_humanoid3"] = \
        launches[name]
  worst = card_vs_cpu(load, lambda mm, dev: general_batch(mm, 8, 13, dev),
                      SLICE_NSTEP, "multi_humanoid3")

  # the wide LDL at every order of WIDE_ORDERS, f64 and f32, against its
  # plain version and timed beside torch.linalg.solve
  ldl = {}
  for n in WIDE_ORDERS:
    for dtype in (torch.float64, torch.float32):
      h, g = wide_ldl_case(n, dtype, n)
      ldl[f"n{n}_{str(dtype)[6:]}"] = wide_ldl_row(
          f"{str(dtype)[6:]} n{n}", h, g)
      del h, g
  torch.cuda.empty_cache()

  # the wide Newton kernel on this scene's rows at f64, then timed at f32
  newton = {}
  for dtype in (torch.float64, torch.float32):
    mm = load(dtype)
    args = solver.newton_args(mm, humanoid_state(mm, B, 3))
    kept = newton_cuda.kept_rows(args[2], args[5], args[4]).sum(1)
    occ = newton_cuda.occupancy(mm.efc.nefc, mm.nv, dtype)
    if dtype == torch.float64:
      out_k = newton_cuda.newton_kernel(*args, 1, 4)
      out_p = newton_cuda.newton_plain(*args, 1, 4)
      viol = newton_violation(out_k, out_p)
      off, worst_other, table = newton_rows_gate(args, out_k, out_p, 1, 4)
      unmatched = [row for row in table if row[1] == 0]
      cap = occ["row_cap"]
      print(f"wide newton f64 B{B} nefc{mm.efc.nefc} nv{mm.nv} it1 ls4 "
            f"({occ['threads']} threads per env): kept "
            f"rows per env mean {kept.double().mean().item():.2f}, most "
            f"{int(kept.max())}, envs past the {cap} shared J rows "
            f"{int((kept > cap).sum())}; worst err / (1e-9 + 1e-9·|plain|) "
            + " ".join(f"{k} {v:.3f}" for k, v in viol.items())
            + f"; {len(off)} envs off elementwise, replayed {table}",
            flush=True)
      if len(off) > B // 100 or not worst_other <= 1.0 or unmatched:
        raise AssertionError("wide newton: kernel and plain disagree")
      newton["f64"] = dict(violation=viol, off_envs=off, replay=table,
                           kept_over_cap=int((kept > cap).sum()),
                           max_abs_err=(out_k[0] - out_p[0]).abs().max()
                           .item())
    else:
      it, ls = 1, 4
      bound_ms, by, dense_ms, _, kept_mean, kept_max = newton_bound(args, it,
                                                                    ls)
      times = dict(
          ms=cuda_ms_cold(lambda: newton_cuda.newton_kernel(*args, it, ls)),
          l2_warm_ms=cuda_ms(lambda: newton_cuda.newton_kernel(*args, it,
                                                                ls)),
          plain_ms=cuda_ms_cold(lambda: newton_cuda.newton_plain(*args, it,
                                                                  ls),
                                reps=5),
          bound_ms=bound_ms, bound_by=by, dense_bound_ms=dense_ms,
          kept_mean=kept_mean, kept_max=kept_max, **occ)
      print(f"wide newton f32 B{B} nefc{mm.efc.nefc} nv{mm.nv} it1 ls4: "
            f"kernel_ms {times['ms']:.4f} (L2 flushed; L2-warm "
            f"{times['l2_warm_ms']:.4f}) plain_ms {times['plain_ms']:.4f} "
            f"bound_ms {bound_ms:.5f} ({by}; kept rows mean {kept_mean:.2f}, "
            f"most {kept_max}; dense {dense_ms:.5f}), {occ['threads']} "
            f"threads per env, {occ['row_cap']} shared J rows, "
            f"{occ['blocks_per_sm']} blocks/SM", flush=True)
      newton["f32"] = times

  # the LDL at the scene's own solve: qM of nv 81, f32
  d = humanoid_state(m, B, 4)
  ldl["qM_n81_f32"] = wide_ldl_row("f32 n81 (multi_humanoid3's qM)",
                                   d.qM.contiguous(),
                                   d.qfrc_smooth.contiguous())
  details["multi_humanoid3"] = dict(
      batch=B, nstep=SLICE_NSTEP, wall_s=wall, env_steps_per_s=sps,
      launches=launches, card_vs_cpu_worst=worst, wide_ldl=ldl,
      wide_newton=newton)
  report["ldl_solve"]["wide"] = ldl
  report["newton_pyramidal"]["wide"] = dict(nv=m.nv, nefc=m.efc.nefc,
                                            **newton["f32"])


def phase_newton_gradient(report, details):
  """14: the Newton kernel's gradient (NewtonSolve) card against CPU."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward, newton_cuda
  grads = {}
  for dev in ("cuda", "cpu"):
    m = zoo.humanoid(torch.float64, device=dev)
    d = general_batch(m, 8, 17, dev)
    qpos = d.qpos.clone()
    qpos[:, 2] -= 0.12                     # feet in the floor
    rng = np.random.default_rng(18)
    qvel = torch.tensor(0.3 * rng.standard_normal(tuple(d.qvel.shape)),
                        device=dev, requires_grad=True)
    ctrl = torch.tensor(rng.uniform(-1, 1, tuple(d.ctrl.shape)),
                        device=dev, requires_grad=True)
    reset_counts()
    out = forward.step(m, forward.step(m, d.replace(qpos=qpos, qvel=qvel,
                                                    ctrl=ctrl)))
    forward_launches = newton_cuda.LAUNCHES
    out.qpos.sum().backward()
    if dev == "cuda":
      torch.cuda.synchronize()
    grads[dev] = (qvel.grad.cpu(), ctrl.grad.cpu(), forward_launches,
                  read_counts())
  rel = max(((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(grads["cuda"][:2], grads["cpu"][:2]))
  print(f"newton gradient: humanoid f64 B8, 2 differentiated steps, "
        f"d Σ qpos / d (qvel, ctrl) card vs CPU max rel err {rel:.3e} "
        f"(limit 1e-8); Newton launches in the forward "
        f"{grads['cuda'][2]}, after the backward {grads['cuda'][3]}",
        flush=True)
  if not rel <= 1e-8 or grads["cuda"][2] != 2 or \
      grads["cuda"][3]["newton_pyramidal"] != 2:
    raise AssertionError(f"newton gradient: rel err {rel}, launches "
                         f"{grads['cuda'][2:]}")
  details["newton_gradient"] = dict(rel_err=rel, launches=grads["cuda"][3])
  report["newton_pyramidal"].setdefault("launches_by_path", {})[
      "gradient_2_steps"] = grads["cuda"][2]


def phase_slice_scenes(report, details):
  """15: humanoid_tendon at full width, every new scene card against CPU,
  and the Newton kernel on the scenes' rows at 4 iterations."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward, megastep_cuda, newton_cuda
  from mujoco_tpu_torch.ops import solver
  from mujoco_tpu_torch.parallel import rollout
  m = zoo.load("humanoid_tendon", torch.float32)
  if megastep_cuda.supported(m):
    raise AssertionError("the megastep admits humanoid_tendon")
  d0 = main_path_batch(m)
  first = forward.fwd_position(m, d0)
  meta = m.efc
  ten_rows = meta.ne + meta.nf + np.nonzero(meta.limit_ten >= 0)[0]
  acting = float(first.efc_active[:, ten_rows].any(1).double().mean())
  out, wall, launches = stage_run(m, d0, SLICE_NSTEP)
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  sps = B * SLICE_NSTEP / wall

  def window():
    rollout.scan_steps(m, out, 5, check=True)
    torch.cuda.synchronize()

  window()
  prof, _ = profile_window(window, 5)
  print(f"humanoid_tendon: f32 B{B} {SLICE_NSTEP} steps: wall {wall:.3f} s, "
        f"{sps:.1f} env-steps/s, launches {launches}, finite {finite}; "
        f"tendon limit rows acting at the start in {acting:.2%} of envs; "
        f"profiled 5 steps: wall {prof['wall_ms_per_step']:.3f} ms/step, "
        f"device busy {prof['device_busy_ms_per_step']:.3f} ms/step, idle "
        f"{prof['device_idle_share']:.2%}, "
        f"{prof['kernel_launches_per_step']:.1f} kernel launches/step",
        flush=True)
  if not finite or launches != {"ldl_solve": SLICE_NSTEP, "newton_pyramidal":
                                SLICE_NSTEP, "megastep": 0} or acting == 0:
    raise AssertionError(f"humanoid_tendon: finite {finite}, launches "
                         f"{launches}, tendon rows acting {acting}")
  for name in ("ldl_solve", "newton_pyramidal"):
    report[name].setdefault("launches_by_path", {})["humanoid_tendon"] = \
        launches[name]
  scenes = {}
  for name in zoo.TENDON + ("humanoid_tendon",):
    worst = card_vs_cpu(lambda dtype, dev, n=name: zoo.load(n, dtype, dev),
                        lambda mm, dev: general_batch(mm, 64, 19, dev),
                        SLICE_NSTEP, f"slice scene {name}")
    scenes[name] = dict(card_vs_cpu_worst=worst)
    mm = zoo.load(name, torch.float64)
    if not mm.efc.nefc:
      continue
    dd = general_batch(mm, B, 20)
    dd = forward.fwd_acceleration(mm, forward.fwd_actuation(
        mm, forward.fwd_velocity(mm, forward.fwd_position(mm, dd))))
    args = solver.newton_args(mm, dd.replace(
        qacc_warmstart=0.9 * dd.qacc_smooth))
    ls = int(mm.opt.ls_iterations)
    out_k = newton_cuda.newton_kernel(*args, 4, ls)
    out_p = newton_cuda.newton_plain(*args, 4, ls)
    viol = newton_violation(out_k, out_p)
    off, worst_other, table = newton_rows_gate(args, out_k, out_p, 4, ls)
    unmatched = [row for row in table if row[1] == 0]
    kept = newton_cuda.kept_rows(args[2], args[5], args[4]).sum(1)
    print(f"newton rows {name}: ne {mm.efc.ne}, nf {mm.efc.nf}, nl "
          f"{mm.efc.nl}, nefc {mm.efc.nefc}; kept rows mean "
          f"{kept.double().mean().item():.2f}; f64 B{B} it4 ls{ls} worst "
          f"err / (1e-9 + 1e-9·|plain|) " + " ".join(
              f"{k} {v:.3f}" for k, v in viol.items())
          + f"; {len(off)} envs off elementwise, replayed {table}",
          flush=True)
    if len(off) > B // 100 or not worst_other <= 1.0 or unmatched:
      raise AssertionError(f"newton rows {name}: kernel and plain disagree")
    scenes[name].update(newton_violation=viol, off_envs=off, replay=table)
  details["slice_scenes"] = dict(
      humanoid_tendon=dict(batch=B, nstep=SLICE_NSTEP, wall_s=wall,
                           env_steps_per_s=sps, launches=launches,
                           tendon_rows_acting_share=acting, profile=prof),
      scenes=scenes)


# --- phases 16-18: the solver and integrator options -----------------------

OPTIONS_NSTEP = 20
RK4 = 1
# steps of phase 18's card-against-CPU run, cut from 50 to keep the phase
# near 90 s: the row-serial sweeps (PGS, noslip's QCQPs) and the elliptic
# core at 100 iterations run 10⁴-10⁵ launches a step on the card (0.2-9 s
# a step, PERF.md §5); the integrator scenes 20. The elliptic sweeps cut
# again (from 2, 2 and 3) when phase 27 came, to keep the script in its
# time; phase 28 cut PGS pyramidal from 10 to 5, balls_elliptic from 2 to
# 1 and the rest from 20 to 10; phase 32 cut PGS pyramidal and noslip
# pyramidal from 5 to 3, noslip_pyramidal_it4 from 10 to 5 and the rest
# (SCENE_NSTEP_REST) from 10 to 6
SCENE_NSTEP = {"pgs_pyramidal": 3, "pgs_elliptic": 1,
               "noslip_pyramidal": 3, "noslip_pyramidal_it4": 5,
               "noslip_elliptic": 1, "noslip_condim4": 1,
               "balls_elliptic": 1}
SCENE_NSTEP_REST = 6
# scenes whose B 3072 step takes seconds: timed on one profiled step
SLOW_SCENES = ("pgs_elliptic", "noslip_elliptic", "noslip_condim4",
               "balls_elliptic")


def start_batch(m, nbatch, seed, device="cuda", lower=0.0):
  """make_batch with 0.01·N(0, 1) qpos from a numpy seed, the root lowered
  by ``lower``: the main path's start at a small batch, the same on the
  card and the CPU."""
  from mujoco_tpu_torch.parallel import rollout
  d = rollout.make_batch(m, nbatch, device=device)
  rng = np.random.default_rng(seed)
  qpos = d.qpos + torch.tensor(0.01 * rng.standard_normal(
      tuple(d.qpos.shape)), dtype=m.dtype, device=device)
  qpos[:, 2] -= lower
  return d.replace(qpos=qpos)


# the elliptic humanoid's start: the main path's, feet pushed into the
# floor so that the cone acts from the first step (at the main path's own
# start the feet hang 0.10 above the floor for ~25 steps)
FEET_IN_FLOOR = 0.12


def lowered(d, lower=FEET_IN_FLOOR):
  qpos = d.qpos.clone()
  qpos[:, 2] -= lower
  return d.replace(qpos=qpos)


def option_batch(name, m, nbatch, seed, device="cuda"):
  """general_batch of a zoo.OPTIONS scene, its zoo.ON_FLOOR bodies on the
  floor."""
  from mujoco_tpu_torch.models import zoo
  d = general_batch(m, nbatch, seed, device)
  qpos = d.qpos.clone()
  for i, z in zoo.ON_FLOOR.get(name, {}).items():
    qpos[:, i] = z
  return d.replace(qpos=qpos)


def cone_state(m, d):
  """(share of the active frictional slots whose solve ends in the
  elliptic cone's middle zone, active frictional slots per env) after the
  forward pass of d."""
  from mujoco_tpu_torch.ops import forward, solver
  from mujoco_tpu_torch.utils.device import const
  dd = forward.forward(m, d)
  jar = (dd.efc_J @ dd.qacc[..., None])[..., 0] - dd.efc_aref
  cone = solver._update(m, dd, jar, with_cost=False)[3]
  active = ((dd.contact.dist < dd.contact.includemargin)
            & const(m.con.condim > 1, m.device))
  n = int(active.sum())
  return (int((cone.mid & active).sum()) / max(n, 1),
          n / active.shape[0])


def profiled(m, d, nstep):
  """A warm window of nstep scan_steps under the profiler."""
  from mujoco_tpu_torch.parallel import rollout

  def window():
    rollout.scan_steps(m, d, nstep, check=True)
    torch.cuda.synchronize()

  window()
  return profile_window(window, nstep)[0]


def print_profile(tag, prof):
  print(f"profile, {tag}: wall {prof['wall_ms_per_step']:.3f} ms/step, "
        f"device busy {prof['device_busy_ms_per_step']:.3f} ms/step, idle "
        f"{prof['device_idle_share']:.2%}, "
        f"{prof['kernel_launches_per_step']:.1f} kernel launches/step",
        flush=True)


def backward_error(h, g, p):
  """Per env ‖H·p − g‖∞ / (‖H‖∞‖p‖∞ + ‖g‖∞), in f64 (0 where g and p are
  0)."""
  h, g, p = h.double(), g.double(), p.double()
  r = (h @ p[..., None])[..., 0] - g
  scale = h.abs().sum(2).amax(1) * p.abs().amax(1) + g.abs().amax(1)
  return r.abs().amax(1) / scale.clamp(min=1e-300)


def ldl_on_newton_system(tag, m, d):
  """The LDL kernel on the general core's first Newton system of d
  (H = M + JᵀWJ + the elliptic cone's blocks + reg·I at the warmstart
  pick) against its plain version. At f64 elementwise, 1e-9 relative. At
  f32 the stiff contact rows leave H ill-conditioned, so that two
  backward-stable solves differ by cond(H)·eps: each is held by its
  backward error instead, per env ‖H·p − g‖∞ / (‖H‖∞‖p‖∞ + ‖g‖∞) in f64
  on the f32 inputs, the kernel's at most 1e-5 (n·eps is 1.6e-6), the
  plain version's printed beside it. Returns the largest
  |kernel − plain|."""
  from mujoco_tpu_torch.ops import forward, solver
  d = forward.fwd_acceleration(m, forward.fwd_actuation(
      m, forward.fwd_velocity(m, forward.fwd_position(m, d))))
  h, grad, _, _ = solver.newton_system(m, d, solver.warmstart(m, d)[0])
  return ldl_gate(f"{tag}'s Newton system", h, grad)


def ldl_gate(tag, h, grad):
  """The LDL kernel on (h, grad) against its plain version: at f64
  elementwise, 1e-9 relative; at f32 by the backward error of each env,
  at most 1e-5 (``ldl_on_newton_system`` says why). Returns the largest
  |kernel − plain|."""
  from mujoco_tpu_torch.ops import linalg_cuda
  p = linalg_cuda.spd_solve_kernel(h, grad)
  torch.cuda.synchronize()
  ref = linalg_cuda.spd_solve_plain(h, grad)
  abs_err = (p - ref).abs().max().item()
  offdiag = (h - torch.diag_embed(torch.diagonal(h, dim1=1, dim2=2))).abs()
  head = (f"ldl_solve on {tag} {str(h.dtype)[6:]} B"
          f"{h.shape[0]} n{h.shape[1]} (largest off-diagonal |H| "
          f"{offdiag.max().item():.3e}):")
  if h.dtype == torch.float64:
    rel = abs_err / ref.abs().max().item()
    print(f"{head} max rel err {rel:.3e} (limit 1e-9)", flush=True)
    ok = rel <= 1e-9
  else:
    ek, ep = backward_error(h, grad, p), backward_error(h, grad, ref)
    fwd = (p - ref).abs().amax(1) / ref.abs().amax(1).clamp(min=1e-30)
    print(f"{head} backward error per env: kernel most {ek.max().item():.3e}"
          f" (limit 1e-5), median {ek.median().item():.3e}; plain most "
          f"{ep.max().item():.3e}, median {ep.median().item():.3e}; "
          f"|kernel − plain| / |plain| per env most {fwd.max().item():.3e}",
          flush=True)
    ok = ek.max().item() <= 1e-5
  if not ok:
    raise AssertionError(f"ldl_solve disagrees on {tag}")
  return abs_err


def phase_humanoid_elliptic(report, details):
  """16: humanoid_elliptic (the elliptic cone at impratio 100, implicitfast)
  at full width through the general core and the LDL kernel."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward, megastep_cuda
  load = lambda dtype, dev="cuda": zoo.load("humanoid_elliptic", dtype, dev)
  m = load(torch.float32)
  if megastep_cuda.supported(m):
    raise AssertionError("the megastep admits humanoid_elliptic")
  ldl_err = {str(dtype)[6:]: ldl_on_newton_system(
      "humanoid_elliptic", load(dtype), lowered(main_path_batch(load(dtype))))
      for dtype in (torch.float64, torch.float32)}
  d0 = lowered(main_path_batch(m))
  mid_start, slots_start = cone_state(m, d0)
  out, wall, launches = stage_run(m, d0, OPTIONS_NSTEP)
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  # the guard puts a diverged env back at d_fresh, whose time is 0
  reset = int((out.time < OPTIONS_NSTEP * float(m.opt.timestep) * 0.999)
              .sum())
  mid_end, slots_end = cone_state(m, out)
  sps = B * OPTIONS_NSTEP / wall
  print(f"humanoid_elliptic: f32 B{B} {OPTIONS_NSTEP} steps from the main "
        f"path's start lowered {FEET_IN_FLOOR}: wall {wall:.3f} s, {sps:.1f} "
        f"env-steps/s, launches {launches} "
        f"({launches['ldl_solve'] / OPTIONS_NSTEP:.1f} LDL per step), finite "
        f"{finite}, envs the guard reset {reset}; active frictional slots "
        f"per env {slots_start:.2f} at the start, {slots_end:.2f} at the end, "
        f"of them in the cone's middle zone {mid_start:.2%} and "
        f"{mid_end:.2%}", flush=True)
  if not finite or launches != {"ldl_solve": 2 * OPTIONS_NSTEP,
                                "newton_pyramidal": 0, "megastep": 0}:
    raise AssertionError(f"humanoid_elliptic: finite {finite}, launches "
                         f"{launches}")
  prof = profiled(m, out, 3)
  print_profile(f"humanoid_elliptic f32 B{B} 3 steps", prof)
  worst = card_vs_cpu(load, lambda mm, dev: start_batch(
      mm, 16, 21, dev, FEET_IN_FLOOR), 10, "humanoid_elliptic")
  # d Σ qpos(one step) / d ctrl through SpdSolve's backward
  grads = {}
  for dev in ("cuda", "cpu"):
    mm = load(torch.float64, dev)
    dd = start_batch(mm, 8, 22, dev, FEET_IN_FLOOR)
    rng = np.random.default_rng(23)
    ctrl = torch.tensor(0.2 * rng.uniform(-1, 1, tuple(dd.ctrl.shape)),
                        device=dev, requires_grad=True)
    reset_counts()
    out1 = forward.step(mm, dd.replace(ctrl=ctrl))
    fwd = read_counts()
    out1.qpos.sum().backward()
    if dev == "cuda":
      torch.cuda.synchronize()
    grads[dev] = (ctrl.grad.cpu(), fwd, read_counts())
  rel = ((grads["cuda"][0] - grads["cpu"][0]).abs().max()
         / grads["cpu"][0].abs().max()).item()
  print(f"humanoid_elliptic gradient: f64 B8, one step, d Σ qpos / d ctrl "
        f"card vs CPU max rel err {rel:.3e} (limit 1e-8); launches in the "
        f"forward {grads['cuda'][1]}, after the backward {grads['cuda'][2]}",
        flush=True)
  if not rel <= 1e-8 or grads["cuda"][1]["ldl_solve"] != 2 or \
      grads["cuda"][2]["ldl_solve"] <= 2:
    raise AssertionError(f"humanoid_elliptic gradient: rel err {rel}, "
                         f"launches {grads['cuda'][1:]}")
  details["humanoid_elliptic"] = dict(
      batch=B, nstep=OPTIONS_NSTEP, wall_s=wall, env_steps_per_s=sps,
      launches=launches, ldl_launches_per_step=launches["ldl_solve"]
      / OPTIONS_NSTEP, profile=prof, middle_zone_share_start=mid_start,
      middle_zone_share_end=mid_end, frictional_slots_start=slots_start,
      frictional_slots_end=slots_end, card_vs_cpu_worst=worst,
      envs_reset=reset, gradient_rel_err=rel,
      gradient_launches=grads["cuda"][2],
      ldl_newton_system_abs_err=ldl_err)
  report["ldl_solve"].setdefault("launches_by_path", {})[
      "humanoid_elliptic"] = launches["ldl_solve"]


def phase_rk4(report, details):
  """17: the flagship humanoid under RK4: four forward passes a step,
  each through the LDL and the Newton kernel."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward, megastep_cuda, newton_cuda
  load = lambda dtype, dev="cuda": zoo.load("humanoid", dtype, dev,
                                            opt={"integrator": RK4})
  m = load(torch.float32)
  if megastep_cuda.supported(m):
    raise AssertionError("the megastep admits the humanoid under RK4")
  out, wall, launches = stage_run(m, main_path_batch(m), OPTIONS_NSTEP)
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  sps = B * OPTIONS_NSTEP / wall
  print(f"humanoid RK4: f32 B{B} {OPTIONS_NSTEP} steps: wall {wall:.3f} s, "
        f"{sps:.1f} env-steps/s, launches {launches}, finite {finite}",
        flush=True)
  if not finite or launches != {"ldl_solve": 4 * OPTIONS_NSTEP,
                                "newton_pyramidal": 4 * OPTIONS_NSTEP,
                                "megastep": 0}:
    raise AssertionError(f"humanoid RK4: finite {finite}, launches "
                         f"{launches}")
  prof = profiled(m, out, 3)
  print_profile(f"humanoid RK4 f32 B{B} 3 steps", prof)
  worst = card_vs_cpu(load, lambda mm, dev: start_batch(mm, 16, 24, dev), 10,
                      "humanoid RK4")
  # the Newton kernel on each forward pass's rows of the first step, f64
  mm = load(torch.float64)
  captured, run = [], newton_cuda.run

  def recording(args, iterations, ls_iter):
    captured.append(args)
    return run(args, iterations, ls_iter)

  newton_cuda.run = recording
  try:
    forward.step(mm, main_path_batch(mm))
  finally:
    newton_cuda.run = run
  it, ls = int(mm.opt.iterations), int(mm.opt.ls_iterations)
  passes = []
  for k, args in enumerate(captured):
    out_k = newton_cuda.newton_kernel(*args, it, ls)
    torch.cuda.synchronize()
    out_p = newton_cuda.newton_plain(*args, it, ls)
    viol = newton_violation(out_k, out_p)
    off, worst_other, table = newton_rows_gate(args, out_k, out_p, it, ls)
    unmatched = [row for row in table if row[1] == 0]
    print(f"newton rows, RK4 forward pass {k + 1} of the first step: f64 "
          f"B{B} it{it} ls{ls} worst err / (1e-9 + 1e-9·|plain|) "
          + " ".join(f"{n} {v:.3f}" for n, v in viol.items())
          + f"; {len(off)} envs off elementwise, replayed {table}",
          flush=True)
    if len(off) > B // 100 or not worst_other <= 1.0 or unmatched:
      raise AssertionError(f"RK4 pass {k + 1}: kernel and plain disagree")
    passes.append(dict(violation=viol, off_envs=off, replay=table))
  if len(captured) != 4:
    raise AssertionError(f"RK4 step made {len(captured)} Newton solves")
  details["rk4"] = dict(batch=B, nstep=OPTIONS_NSTEP, wall_s=wall,
                        env_steps_per_s=sps, launches=launches, profile=prof,
                        card_vs_cpu_worst=worst, newton_passes=passes)
  for name in ("ldl_solve", "newton_pyramidal"):
    report[name].setdefault("launches_by_path", {})["rk4"] = launches[name]


def phase_option_scenes(report, details):
  """18: every scene of zoo.OPTIONS (PGS, noslip, the elliptic cone,
  RK4, implicit, implicitfast): card against CPU at f64, B 64, then its
  rate, launches and idle share at f32, B 3072."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import megastep_cuda
  from mujoco_tpu_torch.parallel import rollout
  scenes = {}
  for name in zoo.OPTIONS:
    t0 = time.perf_counter()
    nstep = SCENE_NSTEP.get(name, SCENE_NSTEP_REST)
    worst = card_vs_cpu(lambda dtype, dev, n=name: zoo.load_scene(n, dtype,
                                                                  dev),
                        lambda mm, dev, n=name: option_batch(n, mm, 64, 25,
                                                             dev),
                        nstep, f"option scene {name}")
    m = zoo.load_scene(name, torch.float32)
    if megastep_cuda.supported(m):
      raise AssertionError(f"the megastep admits {name}")
    d = option_batch(name, m, B, 26)
    slow = name in SLOW_SCENES
    if slow:
      # one step, counted and profiled at once (the profiler's cost is
      # ~0.3 % of such a step)
      torch.cuda.synchronize()
      reset_counts()
      holder = {}
      prof = profile_window(lambda: (holder.update(out=rollout.scan_steps(
          m, d, 1, check=True)), torch.cuda.synchronize()), 1)[0]
      launches, out = read_counts(), holder["out"]
      rate_nstep, wall = 1, prof["wall_ms_per_step"] / 1e3
    else:
      rollout.scan_steps(m, d, 1, check=True)           # warm
      rate_nstep = 5
      out, wall, launches = stage_run(m, d, rate_nstep)
      prof = profiled(m, out, 1)
    finite = bool(torch.isfinite(out.qpos).all()
                  & torch.isfinite(out.qvel).all())
    sps = B * rate_nstep / wall
    print(f"option scene {name}: nefc {m.efc.nefc}, f32 B{B} {rate_nstep} "
          f"steps{' (profiled)' if slow else ''}: wall {wall:.3f} s, "
          f"{sps:.1f} env-steps/s, launches {launches}, finite {finite}; "
          f"scene done in {time.perf_counter() - t0:.1f} s", flush=True)
    print_profile(f"option scene {name} f32 B{B} 1 step", prof)
    if not finite:
      raise AssertionError(f"option scene {name}: non-finite state")
    scenes[name] = dict(card_vs_cpu_nstep=nstep, card_vs_cpu_worst=worst,
                        rate_nstep=rate_nstep, wall_s=wall,
                        env_steps_per_s=sps, launches=launches, profile=prof)
  details["option_scenes"] = scenes
  for name in ("ldl_solve", "newton_pyramidal"):
    report[name].setdefault("launches_by_path", {})["option_scenes"] = sum(
        s["launches"][name] for s in scenes.values())


# the numbers this docstring gives main()'s phases, in their order
PHASE_NUMBERS = ("2", "3", "4", "4b", "5", "6", "7", "8", "9", "10", "11",
                 "12", "13", "14", "15", "16", "17", "18", "19", "20", "21",
                 "22", "23", "24", "25", "26", "27", "28", "29", "30",
                 "31", "32", "33", "34")
MANY_NSTEP = 20
# the sleep scene's card-against-CPU run: long enough for its stack (step
# 79) and its ball (step 48) to fall asleep
SLEEP_CHECK_NSTEP = 100


def free_roots_lowered(m, d, lower):
  """d with every free root lowered by ``lower`` (the humanoids' feet into
  the floor)."""
  qpos = d.qpos.clone()
  for j in np.nonzero(np.asarray(m.jnt_type) == 0)[0]:
    qpos[:, int(m.jnt_qposadr[j]) + 2] -= lower
  return d.replace(qpos=qpos)


def many_batch(m, nbatch, seed, device="cuda"):
  """start_batch with every humanoid's feet in the floor."""
  return free_roots_lowered(m, start_batch(m, nbatch, seed, device),
                            FEET_IN_FLOOR)


def fitting_batch(m, make):
  """The batch of the full-width run: B, or B/2 where one step at B peaks
  above 60 % of the card's memory (printed)."""
  from mujoco_tpu_torch.ops import forward
  total = torch.cuda.get_device_properties(0).total_memory
  nbatch = B
  while True:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
      forward.step(m, make(m, nbatch))
      torch.cuda.synchronize()
      peak = torch.cuda.max_memory_allocated()
    except torch.cuda.OutOfMemoryError:
      peak = float("inf")
    print(f"one step at B{nbatch}: peak memory {peak / 2**30:.2f} GiB of "
          f"{total / 2**30:.2f}", flush=True)
    if peak <= 0.6 * total or nbatch <= 256:
      torch.cuda.empty_cache()
      return nbatch
    nbatch //= 2


def mass_matrix_case(m, nbatch, seed):
  """(qM, g) of nbatch posed states of m on the card: qM from the smooth
  stages alone (no constraint rows, whose f64 Jacobian alone would take
  10.7 GB at B 3072 and nv 270), g ~ N(0, 1)."""
  from mujoco_tpu_torch.ops import smooth
  gen = torch.Generator(device="cuda").manual_seed(seed)
  d = start_batch(m, nbatch, seed)
  d = smooth.crb(m, smooth.com_pos(m, smooth.kinematics(m, d)))
  g = torch.randn(d.qvel.shape, generator=gen, device="cuda", dtype=m.dtype)
  return d.qM.contiguous(), g


def many_run(tag, m, d, nstep, expect):
  """stage_run of nstep steps with the peak memory, then a profiled window
  of 2 steps; fails unless finite with the launch counts expect per step.
  Returns the details."""
  torch.cuda.reset_peak_memory_stats()
  out, wall, launches = stage_run(m, d, nstep)
  peak = torch.cuda.max_memory_allocated()
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  nbatch = d.qpos.shape[0]
  sps = nbatch * nstep / wall
  per_step = {k: v / nstep for k, v in launches.items()}
  print(f"{tag}: f32 B{nbatch} {nstep} steps: wall {wall:.3f} s, {sps:.1f} "
        f"env-steps/s, kernel launches per step {per_step}, finite {finite}, "
        f"peak memory {peak / 2**30:.2f} GiB", flush=True)
  if not finite or per_step != expect:
    raise AssertionError(f"{tag}: finite {finite}, launches per step "
                         f"{per_step}, want {expect}")
  prof = profiled(m, out, 2)
  print_profile(f"{tag} f32 B{nbatch} 2 steps", prof)
  return out, dict(batch=nbatch, nstep=nstep, wall_s=wall,
                   env_steps_per_s=sps, launches=launches,
                   launches_per_step=per_step, peak_memory_bytes=peak,
                   profile=prof)


def phase_islands(report, details):
  """19: multi_humanoid10 (ten humanoids in one scene, nv 270) through
  the island solve, whose Newton systems go to the LDL kernel at n 27,
  then with islands disabled (the Newton kernel at nv 270)."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.models.types import DisableBit
  from mujoco_tpu_torch.ops import island, linalg_cuda, megastep_cuda
  from mujoco_tpu_torch.ops import newton_cuda, solver
  load = lambda dtype, dev="cuda": zoo.load("multi_humanoid10", dtype, dev)
  m = load(torch.float32)
  mono = m.replace(opt=m.opt.replace(
      disableflags=int(m.opt.disableflags) | int(DisableBit.ISLAND)))
  if not island.use_islands(m) or island.use_islands(mono):
    raise AssertionError("the island gate does not split multi_humanoid10")
  if megastep_cuda.supported(m) or not megastep_cuda.supported(mono):
    raise AssertionError("the megastep's gate must refuse multi_humanoid10 "
                         "with islands and admit it without (phase 29)")
  nbatch = fitting_batch(m, lambda mm, n: many_batch(mm, n, 30))
  d0 = many_batch(m, nbatch, 30)
  out, isl = many_run("multi_humanoid10 islands", m, d0, MANY_NSTEP,
                      {"ldl_solve": 2.0, "newton_pyramidal": 0.0,
                       "megastep": 0.0})
  del out
  with stage_path():
    out, mon = many_run("multi_humanoid10 monolithic (ISLAND disabled, "
                        "stage path)", mono, d0, MANY_NSTEP,
                        {"ldl_solve": 1.0, "newton_pyramidal": 1.0,
                         "megastep": 0.0})
  del out
  print(f"islands against monolithic at nv {m.nv}: "
        f"{isl['env_steps_per_s'] / mon['env_steps_per_s']:.3f}x "
        f"env-steps/s", flush=True)

  # the LDL kernel at the island shape: one step's first Newton systems,
  # B·10 of order 27
  ldl = {}
  for dtype, nb in ((torch.float64, 256), (torch.float32, nbatch)):
    mm = load(dtype)
    h, g = island.newton_systems(mm, humanoid_state(mm, nb, 31))
    ldl[str(dtype)[6:]] = ldl_gate("multi_humanoid10's island Newton "
                                   "systems", h, g)
  k_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_kernel(h, g))
  # L2-warm by events around back-to-back calls: each launch (~0.07 ms)
  # outlasts the wrapper's host time, and device_ms's profiler saw 29 of
  # 30 launches in each of five windows at this shape
  w_ms = cuda_ms(lambda: linalg_cuda.spd_solve_kernel(h, g))
  p_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_plain(h, g))
  lib_ms = cuda_ms_cold(lambda: torch.linalg.solve(h, g))
  b_ms, by = ldl_bound(h.shape[0], h.shape[1], h.dtype)
  island_times = dict(n=h.shape[1], systems=h.shape[0], ms=k_ms,
                      l2_warm_ms=w_ms, plain_ms=p_ms, library_ms=lib_ms,
                      bound_ms=b_ms, bound_by=by)
  print(f"ldl_solve at the island shape f32 {h.shape[0]} systems n"
        f"{h.shape[1]}: kernel_ms {k_ms:.4f} (L2 flushed; L2-warm by events "
        f"{w_ms:.4f}) plain_ms {p_ms:.4f} library_ms {lib_ms:.4f} "
        f"(torch.linalg.solve) bound_ms {b_ms:.5f} ({by})", flush=True)
  del h, g

  # the n 270 solve of qacc_smooth (shared memory at f32, device memory at
  # f64), held against its plain version as ldl_gate holds it, and timed
  wide = {}
  for dtype in (torch.float32, torch.float64):
    h, g = mass_matrix_case(load(dtype), nbatch, 32)
    route = linalg_cuda.occupancy(h.shape[1], dtype)["route"]
    err = ldl_gate(f"multi_humanoid10's mass matrix ({route})", h, g)
    k_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_kernel(h, g), reps=10)
    p_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_plain(h, g), reps=10)
    lib_ms = cuda_ms_cold(lambda: torch.linalg.solve(h, g), reps=10)
    b_ms, by = ldl_bound(nbatch, h.shape[1], dtype)
    wide[str(dtype)[6:]] = dict(n=h.shape[1], route=route, ms=k_ms,
                                plain_ms=p_ms, library_ms=lib_ms,
                                bound_ms=b_ms, bound_by=by, max_abs_err=err)
    print(f"ldl_solve {str(dtype)[6:]} B{nbatch} n{h.shape[1]} ({route}): "
          f"kernel_ms {k_ms:.4f} (L2 flushed) plain_ms {p_ms:.4f} "
          f"library_ms {lib_ms:.4f} (torch.linalg.solve) bound_ms "
          f"{b_ms:.5f} ({by})", flush=True)
    del h, g

  # the Newton kernel at nv 270 on the monolithic path's rows: at f64
  # (B 256) elementwise under phase 11's rule, then at f32 and the full
  # width under phase 6's, and timed there
  mono64 = load(torch.float64)
  mono64 = mono64.replace(opt=mono64.opt.replace(
      disableflags=int(mono64.opt.disableflags) | int(DisableBit.ISLAND)))
  nb64 = 256
  args = solver.newton_args(mono64, humanoid_state(mono64, nb64, 33))
  out_k = newton_cuda.newton_kernel(*args, 1, 4)
  torch.cuda.synchronize()
  out_p = newton_cuda.newton_plain(*args, 1, 4)
  viol = newton_violation(out_k, out_p)
  off, worst_other, table = newton_rows_gate(args, out_k, out_p, 1, 4)
  unmatched = [row for row in table if row[1] == 0]
  print(f"newton f64 B{nb64} nefc{m.efc.nefc} nv{m.nv} it1 ls4: worst err "
        f"/ (1e-9 + 1e-9·|plain|) " + " ".join(f"{k} {v:.3f}"
                                                for k, v in viol.items())
        + f"; {len(off)} envs off elementwise (limit {nb64 // 100}), worst "
        f"err / limit on the others {worst_other:.3f}, replayed {table}",
        flush=True)
  if len(off) > nb64 // 100 or not worst_other <= 1.0 or unmatched:
    raise AssertionError("newton at nv 270: kernel and plain disagree")
  newton_f64 = dict(batch=nb64, violation=viol, off_envs=off, replay=table,
                    max_abs_err=(out_k[0] - out_p[0]).abs().max().item())
  del args, out_k, out_p, mono64
  args = solver.newton_args(mono, humanoid_state(mono, nbatch, 33))
  out_k = newton_cuda.newton_kernel(*args, 1, 4)
  torch.cuda.synchronize()
  out_p = newton_cuda.newton_plain(*args, 1, 4)
  f32_gate = newton_f32_gate(f"newton f32 B{nbatch} nv{m.nv} it1 ls4", args,
                             out_k, out_p, 0.99)
  del out_k, out_p
  bound_ms, by, dense_ms, _, kept_mean, kept_max = newton_bound(args, 1, 4)
  occ = newton_cuda.occupancy(m.efc.nefc, m.nv, torch.float32)
  newton = dict(nv=m.nv, nefc=m.efc.nefc, bound_ms=bound_ms, bound_by=by,
                dense_bound_ms=dense_ms, kept_mean=kept_mean,
                kept_max=kept_max, **occ,
                ms=cuda_ms_cold(lambda: newton_cuda.newton_kernel(*args, 1, 4),
                                reps=10),
                plain_ms=cuda_ms_cold(
                    lambda: newton_cuda.newton_plain(*args, 1, 4), reps=2,
                    warmup=1),
                max_abs_err=newton_f64["max_abs_err"])
  print(f"newton f32 B{nbatch} nefc{m.efc.nefc} nv{m.nv} it1 ls4: kernel_ms "
        f"{newton['ms']:.4f} (L2 flushed) plain_ms {newton['plain_ms']:.4f} "
        f"bound_ms {bound_ms:.5f} ({by}; kept rows mean {kept_mean:.2f}, "
        f"most {kept_max}; dense {dense_ms:.5f}); {occ['threads']} threads "
        f"per env, {occ['blocks_per_sm']} blocks/SM, work space in "
        f"{'device' if occ['row_cap'] == 0 else 'shared'} memory",
        flush=True)
  del args
  torch.cuda.empty_cache()

  worst = card_vs_cpu(load, lambda mm, dev: many_batch(mm, 4, 34, dev), 5,
                      "multi_humanoid10 islands")
  details["multi_humanoid10"] = dict(
      islands=isl, monolithic=mon, ldl_island_gate_abs_err=ldl,
      ldl_island=island_times, ldl_n270=wide, newton_nv270=newton,
      newton_nv270_f64_gate=newton_f64, newton_nv270_f32_gate=f32_gate,
      card_vs_cpu_worst=worst)
  report["ldl_solve"]["island"] = island_times
  report["ldl_solve"]["n270"] = wide
  report["newton_pyramidal"]["nv270"] = newton
  report["ldl_solve"].setdefault("launches_by_path", {}).update(
      multi_humanoid10_islands=isl["launches"]["ldl_solve"],
      multi_humanoid10_monolithic=mon["launches"]["ldl_solve"])
  report["newton_pyramidal"].setdefault("launches_by_path", {})[
      "multi_humanoid10_monolithic"] = mon["launches"]["newton_pyramidal"]


def phase_dynamic_pairs(report, details):
  """20: replicate4 (four self-colliding humanoids, three dynamic pair
  groups) through the general core at 8 iterations."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.models.types import DisableBit
  from mujoco_tpu_torch.ops import forward, megastep_cuda
  load = lambda dtype, dev="cuda": zoo.load("replicate4", dtype, dev)
  m = load(torch.float32)
  if megastep_cuda.supported(m) or len(m.con.dyngroups) != 3:
    raise AssertionError("replicate4: the megastep admits it, or its "
                         "groups are not three")
  eulerdamp = (m.has_dof_damping and not m.disabled(DisableBit.EULERDAMP)
               and not m.disabled(DisableBit.DAMPER))
  ldl_per_step = 1 + int(m.opt.iterations) + int(eulerdamp)
  nbatch = fitting_batch(m, lambda mm, n: many_batch(mm, n, 40))
  d0 = many_batch(m, nbatch, 40)
  out, run = many_run("replicate4", m, d0, MANY_NSTEP,
                      {"ldl_solve": float(ldl_per_step),
                       "newton_pyramidal": 0.0, "megastep": 0.0})
  dropped = {}
  for tag, dd in (("start", d0), ("end", out)):
    w = forward.fwd_position(m, dd).warning[:, 1].double()
    dropped[tag] = dict(mean=w.mean().item(), most=int(w.max().item()))
  print(f"replicate4 candidate pairs dropped by the budget per env: "
        f"{dropped}", flush=True)
  del out

  # card against CPU at f64: trajectories and the selected geom pairs
  outs = {}
  for dev in ("cuda", "cpu"):
    mm = load(torch.float64, dev)
    d = many_batch(mm, 4, 41, dev)
    ids = []
    for _ in range(5):
      d = forward.step(mm, d)
      ids.append(d.contact.geomids.cpu())
    outs[dev] = (d.qpos.cpu(), d.qvel.cpu(), torch.stack(ids))
  worst = max(((outs["cuda"][i] - outs["cpu"][i]).abs()
               / (1e-8 + 1e-8 * outs["cpu"][i].abs())).max().item()
              for i in (0, 1))
  same_ids = bool(torch.equal(outs["cuda"][2], outs["cpu"][2]))
  print(f"replicate4: 5 steps f64 B4, card vs CPU worst err / (1e-8 + "
        f"1e-8·|CPU|) {worst:.3f}, selected geom pairs identical "
        f"{same_ids}", flush=True)
  if not worst <= 1.0 or not same_ids:
    raise AssertionError(f"replicate4: card and CPU differ ({worst} × "
                         f"limit, geom pairs identical {same_ids})")
  details["replicate4"] = dict(run, dropped_pairs=dropped,
                               card_vs_cpu_worst=worst)
  report["ldl_solve"].setdefault("launches_by_path", {})["replicate4"] = \
      run["launches"]["ldl_solve"]


def phase_sleep(report, details):
  """21: sleep: the stack scene card against CPU at f64 until its trees
  sleep, then multi_humanoid10_sleep at full width."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward, megastep_cuda
  from mujoco_tpu_torch.parallel import rollout
  outs = {}
  for dev in ("cuda", "cpu"):
    m = zoo.load("sleep_stack", torch.float64, dev)
    d = rollout.make_batch(m, 3, device=dev)
    # env 1 rolls its ball (qvel 12) into the stack, env 2 pushes it
    qvel = d.qvel.clone()
    qvel[1, 12] = 3.0
    qvel[2, 0] = 0.5
    d = d.replace(qvel=qvel)
    asleep = []
    for _ in range(SLEEP_CHECK_NSTEP):
      d = forward.step(m, d)
      asleep.append(d.tree_asleep.cpu())
    outs[dev] = (d.qpos.cpu(), torch.stack(asleep))
  worst = ((outs["cuda"][0] - outs["cpu"][0]).abs()
           / (1e-8 + 1e-8 * outs["cpu"][0].abs())).max().item()
  same = bool(torch.equal(outs["cuda"][1], outs["cpu"][1]))
  final = outs["cpu"][1][-1]
  print(f"sleep_stack: {SLEEP_CHECK_NSTEP} steps f64 B3, card vs CPU qpos "
        f"worst err / (1e-8 + 1e-8·|CPU|) {worst:.3f}, tree_asleep identical "
        f"at every step {same}; tree_asleep at the end {final.tolist()}",
        flush=True)
  if not worst <= 1.0 or not same or not bool((final[0] >= 0).all()):
    raise AssertionError(f"sleep_stack: card and CPU differ ({worst} × "
                         f"limit, tree_asleep identical {same}) or the "
                         f"resting stack is awake")

  # the stack at full width, f32: a third of the envs left at rest, a
  # third rolling the ball into the stack, a third pushing the stack, so
  # that at the end some trees sleep and others are awake in one batch
  # (masked rows, the awake mask on qacc, the countdown's zeroing)
  m = zoo.load("sleep_stack", torch.float32)
  d = rollout.make_batch(m, B)
  qvel = d.qvel.clone()
  qvel[1::3, 12] = 3.0
  qvel[2::3, 0] = 0.5
  out, wall, launches = stage_run(m, d.replace(qvel=qvel), SLEEP_CHECK_NSTEP)
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  asleep = out.tree_asleep >= 0
  stack_share = asleep.double().mean().item()
  by_start = [asleep[k::3].double().mean().item() for k in range(3)]
  per_step = {k: v / SLEEP_CHECK_NSTEP for k, v in launches.items()}
  stack_sps = B * SLEEP_CHECK_NSTEP / wall
  print(f"sleep_stack: f32 B{B} {SLEEP_CHECK_NSTEP} steps: wall {wall:.3f} "
        f"s, {stack_sps:.1f} env-steps/s, kernel launches per step "
        f"{per_step}, finite {finite}; share of trees asleep at the end "
        f"{stack_share:.4f} (at rest {by_start[0]:.4f}, ball rolled "
        f"{by_start[1]:.4f}, stack pushed {by_start[2]:.4f})", flush=True)
  if (not finite or not launches["ldl_solve"] or launches["megastep"]
      or not stack_share > 0):
    raise AssertionError(f"sleep_stack f32 B{B}: finite {finite}, launches "
                         f"{launches}, share asleep {stack_share}")
  prof = profiled(m, out, 2)
  print_profile(f"sleep_stack f32 B{B} 2 steps, {stack_share:.4f} of trees "
                f"asleep", prof)
  stack = dict(batch=B, nstep=SLEEP_CHECK_NSTEP, wall_s=wall,
               env_steps_per_s=stack_sps, launches=launches,
               launches_per_step=per_step, asleep_share=stack_share,
               asleep_share_by_start=by_start, profile=prof)
  del out

  # ten humanoids with sleep enabled: a rate (none settles in a few steps)
  m = zoo.load("multi_humanoid10_sleep", torch.float32)
  if megastep_cuda.supported(m):
    raise AssertionError("the megastep admits multi_humanoid10_sleep")
  nbatch = fitting_batch(m, lambda mm, n: many_batch(mm, n, 50))
  out, run = many_run("multi_humanoid10_sleep", m, many_batch(m, nbatch, 50),
                      MANY_NSTEP, {"ldl_solve": 2.0, "newton_pyramidal": 0.0,
                                   "megastep": 0.0})
  share = (out.tree_asleep >= 0).double().mean().item()
  print(f"multi_humanoid10_sleep: share of trees asleep after {MANY_NSTEP} "
        f"steps {share:.4f}", flush=True)
  details["sleep"] = dict(sleep_stack_card_vs_cpu_worst=worst,
                          sleep_stack_final=final.tolist(),
                          sleep_stack_full_width=stack,
                          multi_humanoid10_sleep=dict(run,
                                                      asleep_share=share))
  report["ldl_solve"].setdefault("launches_by_path", {}).update(
      sleep_stack=launches["ldl_solve"],
      multi_humanoid10_sleep=run["launches"]["ldl_solve"])


# ---- collision breadth: phases 22 and 23

COLLIDER_PAIRS = 4096
COLLIDER_COPIES = 2048
COLLIDER_TOL = 1e-10    # card against CPU at f64, absolute plus relative
SCENE_COPIES = 256


def collider_poses(kind, seed, device, dtype):
  """(p1, m1, s1, p2, m2, s2) of COLLIDER_PAIRS pairs from a numpy seed,
  shaped as the collision driver gives them (poses (1, P, ...), sizes
  (P, 3)): centers up to 0.2 apart, a third of them at a tenth of that
  (deep), sizes 0.05-0.15; for a plane (geom 1) a tilted one at the
  origin, for the height field the bowl of hfield_bowl unrotated with the
  other geom from 0.1 below its surface to 0.15 above."""
  rng = np.random.default_rng(seed)
  n = COLLIDER_PAIRS

  def rot(k):
    q = rng.standard_normal((k, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                    -1).reshape(k, 3, 3)

  spread = 0.12 if kind == "mpr" else 0.2
  p1 = rng.uniform(-spread, spread, (n, 3))
  p2 = rng.uniform(-spread, spread, (n, 3))
  p2[: n // 3] = p1[: n // 3] + 0.1 * (p2[: n // 3] - p1[: n // 3])
  m1, m2 = rot(n), rot(n)
  s1 = rng.uniform(0.05, 0.15, (n, 3))
  s2 = rng.uniform(0.05, 0.15, (n, 3))
  if kind in ("plane", "terrain"):
    p1[:] = 0.0
    m1[:] = np.eye(3) if kind == "terrain" else rot(1)
  if kind == "terrain":
    p2[:, :2] = rng.uniform(-1.3, 1.3, (n, 2))
    p2[:, 2] = 0.1 * (p2[:, 0] ** 2 / 1.44 + p2[:, 1] ** 2) \
        + rng.uniform(-0.1, 0.15, n)
  t = lambda a: torch.tensor(a, dtype=dtype, device=device)
  return (t(p1)[None], t(m1)[None], t(s1), t(p2)[None], t(m2)[None], t(s2))


def collider_cases():
  """name → (model, pose kind, make(m) → collider): every collider
  function this slice adds, on the rock's mesh and the bowl's terrain."""
  from mujoco_tpu_torch.models.types import GeomType as G
  from mujoco_tpu_torch.ops import collision_box, collision_convex
  from mujoco_tpu_torch.ops import collision_hfield as hf
  from mujoco_tpu_torch.ops import collision_mesh as cm
  from mujoco_tpu_torch.ops import collision_primitive as cp
  fixed = lambda fn: (lambda m: fn)
  cases = {
      "plane_cylinder": (None, "plane", fixed(cp.plane_cylinder)),
      "plane_ellipsoid": (None, "plane", fixed(cp.plane_ellipsoid)),
      "sphere_cylinder": (None, "free", fixed(cp.sphere_cylinder)),
      "capsule_box": (None, "free", fixed(cp.capsule_box)),
      "box_box": (None, "free", fixed(collision_box.box_box)),
      "mpr_ellipsoid_ellipsoid": (None, "mpr", lambda m: (
          collision_convex.make_convex_convex(m, G.ELLIPSOID, G.ELLIPSOID,
                                              -1, -1))),
      "mpr_box_mesh": ("rock", "mpr", lambda m: (
          collision_convex.make_convex_convex(m, G.BOX, G.MESH, -1, 0))),
      "plane_mesh": ("rock", "plane", lambda m: cm.make_plane_mesh(m, 0)),
      "sphere_mesh": ("rock", "free", lambda m: cm.make_sphere_mesh(m, 0)),
      "capsule_mesh": ("rock", "free", lambda m: cm.make_capsule_mesh(m, 0)),
      "hfield_sphere": ("hfield_bowl", "terrain",
                        lambda m: hf.make_hfield_sphere(m, 0)),
      "hfield_capsule": ("hfield_bowl", "terrain",
                         lambda m: hf.make_hfield_capsule(m, 0)),
  }
  for t2, did in ((G.BOX, -1), (G.CYLINDER, -1), (G.ELLIPSOID, -1),
                  (G.MESH, 0)):
    cases[f"hfield_{t2.name.lower()}"] = (
        "hfield_bowl", "terrain",
        lambda m, t2=t2, did=did: hf.make_hfield_convex(m, 0, t2, did))
  return cases


def last_bits(shape, gen):
  """Relative moves of a last-bit copy: 1e-15·N(0, 1)."""
  return 1e-15 * torch.randn(shape, generator=gen, dtype=torch.float64)


def explained(mine, theirs, copies, tol):
  """Per env (dim 0 of each output), whether copies (per output (env,
  copy, ...)), the other side rerun on last-bit copies of each env's
  input, account for mine where it misses theirs: some copy gives mine
  (every output within tol, absolute plus relative), or the copies move
  by as much themselves (for every output, |mine − theirs| within tol of
  the largest |copy − theirs|), or, where the copies disagree among
  themselves, they bracket mine (every element within the copies' range
  widened by its own width)."""
  n, k = copies[0].shape[:2]
  hit = torch.ones((n, k), dtype=torch.bool)
  within = torch.ones(n, dtype=torch.bool)
  inside = torch.ones(n, dtype=torch.bool)
  chaotic = torch.zeros(n, dtype=torch.bool)
  for a, b, r in zip(mine, theirs, copies):
    a, b, r = a.cpu().double(), b.cpu().double(), r.cpu().double()
    hit &= ((r - a[:, None]).abs() <= tol + tol * r.abs()).reshape(
        n, k, -1).all(-1)
    spread = (r - b[:, None]).abs().reshape(n, -1).amax(-1)
    within &= (a - b).abs().reshape(n, -1).amax(-1) <= spread + tol
    lo, hi = r.amin(1), r.amax(1)
    width = hi - lo
    gate = tol + tol * a.abs()
    inside &= ((a >= lo - width - gate) & (a <= hi + width + gate)).reshape(
        n, -1).all(-1)
    chaotic |= width.reshape(n, -1).amax(-1) > tol
  return hit.any(1) | within | (inside & chaotic)


def judge_envs(card, cpu, rerun, rerun_card, copies_of, tol, share):
  """Envs (dim 1 of each output, dim 0 of size 1) where the card misses
  the CPU by more than tol (absolute plus relative), each judged as the
  tests judge a degenerate env: it passes if the CPU, rerun on last-bit
  copies of its input (``rerun(idx)``), accounts for the card's result
  (``explained``), or the card, rerun on the same copies
  (``rerun_card(idx)``), accounts for the CPU's: the env's result is then
  decided by the last bit, on one side at least (the card rounds inside
  a step otherwise than the CPU does: fused multiply-adds, reduction
  orders). Fails when an env is unexplained or more than ``share`` of the
  envs miss. Returns the count judged."""
  nenv = card[0].shape[1]
  miss = torch.zeros(nenv, dtype=torch.bool)
  for a, b in zip(card, cpu):
    a, b = a.cpu().double(), b.cpu().double()
    bad = (a - b).abs() > tol + tol * b.abs()
    miss |= bad.reshape(bad.shape[0], nenv, -1).any(-1).any(0)
  idx = torch.nonzero(miss)[:, 0]
  if len(idx) > share * nenv:
    raise AssertionError(f"{len(idx)} of {nenv} envs differ (limit "
                         f"{share:.0%})")
  if not len(idx):
    return 0
  pick = lambda outs, i: [o.cpu()[0, i] for o in outs]
  ok = explained(pick(card, idx), pick(cpu, idx), rerun(idx), tol)
  if not bool(ok.all()):
    rest = idx[~ok]
    ok[~ok] = explained(pick(cpu, rest), pick(card, rest), rerun_card(rest),
                        tol)
  if not bool(ok.all()):
    for j in torch.nonzero(~ok)[:3, 0].tolist():
      for o, (a, b) in enumerate(zip(card, cpu)):
        print(f"env {int(idx[j])} output {o}: card "
              f"{a.cpu()[0, idx[j]].flatten().tolist()} CPU "
              f"{b.cpu()[0, idx[j]].flatten().tolist()}", flush=True)
    raise AssertionError(f"envs {idx[~ok].tolist()} differ beyond both "
                         f"sides' last-bit spread")
  return len(idx)


def collider_family(name: str) -> str:
  """primitive, box, convex (MPR), mesh or hfield."""
  if name == "box_box":
    return "box"
  if name.startswith("mpr"):
    return "convex"
  if name.startswith("hfield"):
    return "hfield"
  return "mesh" if name.endswith("mesh") else "primitive"


def collider_check(name, seed, models):
  """The collider ``name`` of collider_cases at f64 on the card against
  the CPU on COLLIDER_PAIRS seeded poses, judged by judge_envs (2 % of
  envs, 5 % for MPR). models[(scene, device, dtype)] holds the Models;
  returns (the collider and its poses by (device, dtype), the envs
  judged)."""
  model, kind, make = collider_cases()[name]
  keys = (("cuda", torch.float64), ("cpu", torch.float64),
          ("cuda", torch.float32))
  fns = {key: make(models.get((model,) + key)) for key in keys}
  args = {key: collider_poses(kind, seed, *key) for key in keys}
  card = fns["cuda", torch.float64](*args["cuda", torch.float64])
  cpu = fns["cpu", torch.float64](*args["cpu", torch.float64])

  def rerun(idx, key):
    k = COLLIDER_COPIES
    gen = torch.Generator().manual_seed(0)
    sel = idx.repeat_interleave(k)
    moved = []
    for j, x in enumerate(args["cpu", torch.float64]):
      x = x[sel] if j in (2, 5) else x[:, sel]
      if j in (0, 1, 3, 4):
        x = x * (1 + last_bits(x.shape, gen))
      moved.append(x.to(key[0]))
    return [r[0].reshape((len(idx), k) + r.shape[2:])
            for r in fns[key](*moved)]

  share = 0.05 if collider_family(name) == "convex" else 0.02
  judged = judge_envs(card, cpu,
                      lambda idx: rerun(idx, ("cpu", torch.float64)),
                      lambda idx: rerun(idx, ("cuda", torch.float64)),
                      COLLIDER_COPIES, COLLIDER_TOL, share)
  return fns, args, card, judged


def collider_models(device_dtypes) -> dict:
  """The Models of the colliders' mesh and height field (rock,
  hfield_bowl) on each (device, dtype)."""
  from mujoco_tpu_torch.models import zoo
  return {(name,) + key: zoo.load(name, key[1], key[0])
          for name in ("rock", "hfield_bowl") for key in device_dtypes}


def collider_launches(fn, attempts=3):
  """Kernel launches per call of fn (three collider calls) from the
  profiler, or None where it records no device kernel in any of
  ``attempts`` windows (it dropped a whole window of one call late in a
  full run): a count the script prints, not a gate."""
  for _ in range(attempts):
    try:
      return profile_window(fn, 3)[0]["kernel_launches_per_step"]
    except AssertionError:
      continue
  return None


def phase_colliders(report, details):
  """22: each new collider at f64 on the card against the CPU on 4,096
  seeded poses, the f32 distances against the f64 ones, and its ms per
  call at f32."""
  models = collider_models((("cuda", torch.float64), ("cpu", torch.float64),
                            ("cuda", torch.float32)))
  out = {}
  for i, name in enumerate(collider_cases()):
    fns, args, card, judged = collider_check(name, 100 + i, models)
    d32 = fns["cuda", torch.float32](*args["cuda", torch.float32])[0]
    d64 = card[0]
    # a slot holds a contact where its dist is not the 1e10 of an empty or
    # dropped one; f32 and f64 may disagree on that (MPR's dedup)
    real32, real64 = d32.abs() < 1.0, d64.abs() < 1.0
    both = real32 & real64
    flips = int((real32 != real64).sum())
    gap = (d32.double() - d64)[both].abs()
    q = torch.quantile(gap.cpu(), torch.tensor([0.5, 0.99], dtype=gap.dtype))
    fn32, a32 = fns["cuda", torch.float32], args["cuda", torch.float32]
    ms = cuda_ms(lambda: fn32(*a32), reps=5, warmup=1)

    def thrice():
      for _ in range(3):
        fn32(*a32)
      torch.cuda.synchronize()

    launches = collider_launches(thrice)
    out[name] = dict(envs_judged_by_copies=judged,
                     f32_dist_gap_median=q[0].item(),
                     f32_dist_gap_p99=q[1].item(),
                     f32_dist_gap_max=gap.max().item(),
                     contacts=int(both.sum()), f32_slot_flips=flips,
                     ms_f32=ms, launches_per_call=launches)
    print(f"collider {name}: {COLLIDER_PAIRS} pairs, card = CPU at f64 "
          f"({judged} envs judged by last-bit copies); f32 − f64 |dist| "
          f"median {q[0].item():.3e}, p99 {q[1].item():.3e}, most "
          f"{gap.max().item():.3e} over {int(both.sum())} contacts ("
          f"{flips} slots a contact at one precision only); {ms:.3f} ms "
          f"and {'not measured' if launches is None else f'{launches:.0f}'}"
          f" kernel launches per call at f32", flush=True)
  details["colliders"] = out


# the rock scene posed at rest: the rock on the floor, the sphere on the
# rock, the box on the sphere (qpos index → height); the bowl's six bodies
# 0.005 into the terrain under each
CONVEX_REST = {"rock": {2: 0.15, 9: 0.385, 16: 0.505},
               "hfield_bowl": {2: 0.115, 9: 0.081, 16: 0.075, 23: 0.105,
                               30: 0.061, 37: 0.025}}
CONVEX_FULL = ("box_pile", "grasp", "hfield_bowl")
ROCK_NSTEP = 25
CONVEX_NSTEP = 10
# card against CPU, cut from 20 when phase 27 came, to keep the script in
# its time
# cut from 20 when phase 27 came and from 10 when phase 28 came
CONVEX_CHECK_NSTEP = 5


def convex_batch(name, m, nbatch, seed, device="cuda"):
  """start_batch of a zoo.CONVEX scene with its bodies at CONVEX_REST
  (noise kept) and every control at 1 (the grasp's fingers close)."""
  d = start_batch(m, nbatch, seed, device)
  qpos = d.qpos.clone()
  for i, z in CONVEX_REST.get(name, {}).items():
    qpos[:, i] += z - float(m.qpos0[i])
  return d.replace(qpos=qpos, ctrl=torch.ones_like(d.ctrl))


def take_envs(d, idx):
  """The envs idx of a Data (every field batched, Contact too)."""
  import dataclasses
  kw = {}
  for f in dataclasses.fields(d):
    v = getattr(d, f.name)
    kw[f.name] = take_envs(v, idx) if dataclasses.is_dataclass(v) else v[idx]
  return type(d)(**kw)


def convex_card_vs_cpu(name):
  """CONVEX_CHECK_NSTEP steps at f64, B 4: each step of the CPU's state on
  the card and on the CPU, qpos and qvel within 1e-8 absolute plus
  relative, an env that misses judged by last-bit copies of its state on
  both sides (judge_envs). Returns the env-steps judged."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward
  mc = zoo.load(name, torch.float64, "cuda")
  mh = zoo.load(name, torch.float64, "cpu")
  d = convex_batch(name, mh, 4, 61, "cpu")
  judged = 0
  for _ in range(CONVEX_CHECK_NSTEP):
    out_h = forward.step(mh, d)
    out_c = forward.step(mc, d.to("cuda"))

    def rerun(idx, m, d=d):
      k = SCENE_COPIES
      gen = torch.Generator().manual_seed(0)
      copies = take_envs(d, idx.repeat_interleave(k))
      moved = {f: getattr(copies, f) * (1 + last_bits(
          getattr(copies, f).shape, gen)) for f in ("qpos", "qvel")}
      r = forward.step(m, copies.replace(**moved).to(m.device))
      return [x.reshape((len(idx), k) + x.shape[1:]) for x in (r.qpos,
                                                                r.qvel)]

    judged += judge_envs([out_c.qpos[None], out_c.qvel[None]],
                         [out_h.qpos[None], out_h.qvel[None]],
                         lambda idx: rerun(idx, mh),
                         lambda idx: rerun(idx, mc), SCENE_COPIES, 1e-8,
                         1.0)
    d = out_h
  return judged


def phase_convex_scenes(report, details):
  """23: the slice at full width: rock (f32, B 3072, 25 steps of
  scan_steps on the stage path), box_pile, grasp and hfield_bowl (10
  steps each), card against CPU at f64, and the LDL kernel at the rock's
  n 18."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import linalg_cuda, megastep_cuda, solver
  m = zoo.load("rock", torch.float32)
  if megastep_cuda.supported(m):
    raise AssertionError("the megastep admits the rock scene")
  d0 = convex_batch("rock", m, B, 60)
  torch.cuda.reset_peak_memory_stats()
  out, wall, launches = stage_run(m, d0, ROCK_NSTEP)
  peak = torch.cuda.max_memory_allocated()
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  # the guard puts a diverged env back at d_fresh, whose time is 0
  reset = (out.time < ROCK_NSTEP * float(m.opt.timestep) * 0.999)
  reset_share = reset.double().mean().item()
  per_step = {k: v / ROCK_NSTEP for k, v in launches.items()}
  sps = B * ROCK_NSTEP / wall
  from mujoco_tpu_torch.ops import forward
  con = forward.fwd_position(m, out).contact
  active = (con.dist < con.includemargin).double().sum(1)
  del con
  print(f"rock (nv {m.nv}, 1,000-vertex mesh, ncon {m.con.ncon}): f32 B{B} "
        f"{ROCK_NSTEP} steps: wall {wall:.3f} s, {sps:.1f} env-steps/s, "
        f"kernel launches per step {per_step}, finite {finite}, share of "
        f"envs the guard reset {reset_share:.4f}, peak memory "
        f"{peak / 2**30:.2f} GiB, active contacts per env at the end mean "
        f"{active.mean().item():.2f}", flush=True)
  if (not finite or launches["newton_pyramidal"] or launches["megastep"]
      or launches["ldl_solve"] < 2 * ROCK_NSTEP):
    raise AssertionError(f"rock: finite {finite}, launches {launches}")
  reset_counts()
  _, niters = run_steps(m, out, CONVEX_NSTEP)
  torch.cuda.synchronize()
  counted = read_counts()
  need = CONVEX_NSTEP + int(niters.max(0).values.sum())
  mean_it = niters.double().mean().item()
  print(f"rock Newton iterations per env-step: mean {mean_it:.3f}, most "
        f"{int(niters.max())}; LDL launches {counted['ldl_solve']} in "
        f"{CONVEX_NSTEP} steps (need ≥ {need})", flush=True)
  if counted["ldl_solve"] < need:
    raise AssertionError(f"rock launches {counted}, need {need} LDL")
  prof = profiled(m, out, 2)
  print_profile(f"rock f32 B{B} 2 steps", prof)
  rock = dict(batch=B, nstep=ROCK_NSTEP, wall_s=wall, env_steps_per_s=sps,
              launches=launches, launches_per_step=per_step,
              newton_iterations_mean=mean_it,
              newton_iterations_most=int(niters.max()),
              peak_memory_bytes=peak, guard_reset_share=reset_share,
              profile=prof)

  # the LDL kernel on the rock's Newton systems at n 18, f32 by backward
  # error and f64 elementwise, and timed at f32
  ldl = ldl_on_newton_system("rock", m, out)
  m64 = zoo.load("rock", torch.float64)
  ldl64 = ldl_on_newton_system("rock", m64, convex_batch("rock", m64, B, 60))
  dd = forward.fwd_acceleration(m, forward.fwd_actuation(
      m, forward.fwd_velocity(m, forward.fwd_position(m, out))))
  h, g, _, _ = solver.newton_system(m, dd, solver.warmstart(m, dd)[0])
  h = h.contiguous()
  k_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_kernel(h, g))
  # L2-warm by events around back-to-back calls (the wrapper's host time
  # where the kernel is shorter): device_ms's profiler saw 29 of 30
  # launches in each of five windows at this shape
  w_ms = cuda_ms(lambda: linalg_cuda.spd_solve_kernel(h, g))
  p_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_plain(h, g))
  lib_ms = cuda_ms_cold(lambda: torch.linalg.solve(h, g))
  b_ms, by = ldl_bound(h.shape[0], h.shape[1], h.dtype)
  n18 = dict(n=h.shape[1], systems=h.shape[0], ms=k_ms, l2_warm_ms=w_ms,
             plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=by,
             launches_per_step=per_step["ldl_solve"],
             max_abs_err_f32=ldl, max_abs_err_f64=ldl64)
  print(f"ldl_solve at the rock's shape f32 B{h.shape[0]} n{h.shape[1]}: "
        f"kernel_ms {k_ms:.4f} (L2 flushed; L2-warm by events {w_ms:.4f}) "
        f"plain_ms "
        f"{p_ms:.4f} library_ms {lib_ms:.4f} (torch.linalg.solve) bound_ms "
        f"{b_ms:.5f} ({by})", flush=True)
  del out, dd, h, g

  scenes = {}
  for name in CONVEX_FULL:
    mm = zoo.load(name, torch.float32)
    o, wall, launches = stage_run(mm, convex_batch(name, mm, B, 62),
                                  CONVEX_NSTEP)
    finite = bool(torch.isfinite(o.qpos).all() & torch.isfinite(o.qvel).all())
    sps = B * CONVEX_NSTEP / wall
    print(f"{name}: f32 B{B} {CONVEX_NSTEP} steps: wall {wall:.3f} s, "
          f"{sps:.1f} env-steps/s, launches {launches}, finite {finite}",
          flush=True)
    if not finite or not launches["ldl_solve"] or launches["megastep"]:
      raise AssertionError(f"{name}: finite {finite}, launches {launches}")
    scenes[name] = dict(wall_s=wall, env_steps_per_s=sps, launches=launches)
    del o

  judged = {}
  for name in ("rock",) + CONVEX_FULL:
    judged[name] = convex_card_vs_cpu(name)
    print(f"{name}: {CONVEX_CHECK_NSTEP} steps f64 B4, each from the CPU's "
          f"state, card = CPU (qpos, qvel 1e-8; {judged[name]} env-steps "
          f"judged by last-bit copies)", flush=True)
  details["convex_scenes"] = dict(rock=rock, full_width=scenes,
                                  card_vs_cpu_judged=judged, ldl_n18=n18)
  report["ldl_solve"]["n18"] = n18
  report["ldl_solve"].setdefault("launches_by_path", {}).update(
      rock=rock["launches"]["ldl_solve"],
      **{name: s["launches"]["ldl_solve"] for name, s in scenes.items()})


# ---- sensors and activation state: phase 24

SENSOR_NSTEP = 50
SENSOR_CHECK_NSTEP = 20
SENSOR_SMALL_NSTEP = 10


def sensor_batch(m, nbatch, seed, device="cuda", lower=None):
  """The main path's start with the root lowered by ``lower`` (a
  humanoid), else general_batch (a small scene), with ctrl 0.5·N(0, 1)
  and act 0.2·N(0, 1) from the seed (the filters and muscles move from
  the first step)."""
  d = (general_batch(m, nbatch, seed, device) if lower is None
       else start_batch(m, nbatch, seed, device, lower))
  rng = np.random.default_rng(seed + 1)
  t = lambda a: torch.tensor(a, dtype=m.dtype, device=device)
  return d.replace(ctrl=t(0.5 * rng.standard_normal(tuple(d.ctrl.shape))),
                   act=t(0.2 * rng.standard_normal(tuple(d.act.shape))))


def kernel_count(fn, attempts=5) -> int:
  """Device kernels of one warm call of fn: the most the profiler saw in
  ``attempts`` windows of one call each (it misses events now and then,
  so a window's count is a lower bound)."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  most = 0
  for _ in range(attempts):
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
      fn()
      torch.cuda.synchronize()
    most = max(most, sum(1 for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA))
  return most


def sensor_card_vs_cpu(name, nbatch, nstep, make,
                       compared=("qpos", "qvel", "act", "sensordata")):
  """nstep steps at f64 of make(m, device): each step of the CPU's state
  on the card and on the CPU; the ``compared`` fields (qpos, qvel, act and
  sensordata) within 1e-8 absolute plus relative, an env that misses
  judged by last-bit copies of its state (qpos, qvel, act) on both sides
  (judge_envs). Returns the env-steps judged."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward
  mc = zoo.load(name, torch.float64, "cuda")
  mh = zoo.load(name, torch.float64, "cpu")
  d = make(mh, "cpu")
  fields = tuple(f for f in compared if getattr(d, f).shape[1])
  judged = 0
  for _ in range(nstep):
    out_h = forward.step(mh, d)
    out_c = forward.step(mc, d.to("cuda"))

    def rerun(idx, m, d=d):
      k = SCENE_COPIES
      gen = torch.Generator().manual_seed(0)
      copies = take_envs(d, idx.repeat_interleave(k))
      moved = {f: getattr(copies, f) * (1 + last_bits(
          getattr(copies, f).shape, gen)) for f in ("qpos", "qvel", "act")}
      r = forward.step(m, copies.replace(**moved).to(m.device))
      return [getattr(r, f).reshape((len(idx), k) + getattr(r, f).shape[1:])
              for f in fields]

    judged += judge_envs([getattr(out_c, f)[None] for f in fields],
                         [getattr(out_h, f)[None] for f in fields],
                         lambda idx: rerun(idx, mh),
                         lambda idx: rerun(idx, mc), SCENE_COPIES, 1e-8,
                         1.0)
    d = out_h
  return judged


def phase_sensors(report, details):
  """24: sensors and activation state: humanoid_sensors (the flagship
  with 87 sensors and 21 filtered actuators; the megastep must refuse it)
  at f32, B 3072, 50 steps on the stage path; its sensor stages' launches;
  card against CPU at f64 for it and the five small scenes."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.models.types import DisableBit, SensorType
  from mujoco_tpu_torch.ops import forward, megastep_cuda, sensor
  m = zoo.load("humanoid_sensors", torch.float32)
  if megastep_cuda.supported(m):
    raise AssertionError("the megastep admits humanoid_sensors")
  d0 = sensor_batch(m, B, 70, lower=FEET_IN_FLOOR)
  torch.cuda.reset_peak_memory_stats()
  out, wall, launches = stage_run(m, d0, SENSOR_NSTEP)
  peak = torch.cuda.max_memory_allocated()
  finite = all(bool(torch.isfinite(getattr(out, f)).all())
               for f in ("qpos", "qvel", "act"))
  # scan_steps keeps the state alone: the last step's sensors are those
  # of a forward pass from the final state
  fwd = forward.forward(m, out)
  finite &= bool(torch.isfinite(fwd.sensordata).all())
  touch = np.nonzero(np.asarray(m.sensor_type) == SensorType.TOUCH)[0]
  touch_share = (fwd.sensordata[:, m.sensor_adr[touch]] > 0).any(
      -1).double().mean().item()
  run_launches = {k: v / SENSOR_NSTEP for k, v in launches.items()}
  sps = B * SENSOR_NSTEP / wall
  print(f"humanoid_sensors (nv {m.nv}, na {m.na}, {m.nsensor} sensors, "
        f"{m.nsensordata} values): f32 B{B} {SENSOR_NSTEP} steps from the "
        f"main path's start lowered {FEET_IN_FLOOR}: wall {wall:.3f} s, "
        f"{sps:.1f} env-steps/s, kernel launches per step {run_launches}, "
        f"finite {finite}, share of envs with a touch above 0 "
        f"{touch_share:.4f}, peak memory {peak / 2**30:.2f} GiB",
        flush=True)
  if (not finite or launches["ldl_solve"] != SENSOR_NSTEP
      or launches["newton_pyramidal"] != SENSOR_NSTEP
      or launches["megastep"] or not touch_share > 0):
    raise AssertionError(f"humanoid_sensors: finite {finite}, launches "
                         f"{launches}, touch share {touch_share}")
  prof = profiled(m, out, 2)
  print_profile(f"humanoid_sensors f32 B{B} 2 steps", prof)
  m_off = m.replace(opt=m.opt.replace(
      disableflags=int(m.opt.disableflags) | int(DisableBit.SENSOR)))
  prof_off = profiled(m_off, out, 2)
  print_profile(f"humanoid_sensors, sensors disabled, f32 B{B} 2 steps",
                prof_off)
  # the kernels of one forward.step (no scan_steps set-up in the count):
  # with sensors, without (their difference the sensor stages'), and the
  # flagship from the same start (the activations' share against the
  # sensor-less step)
  hum = zoo.humanoid(torch.float32)
  d_hum = sensor_batch(hum, B, 70, lower=FEET_IN_FLOOR)
  per_step = {tag: kernel_count(lambda mm=mm, dd=dd: forward.step(mm, dd))
              for tag, mm, dd in (("sensors", m, out), ("no_sensors", m_off,
                                                        out),
                                  ("flagship", hum, d_hum))}
  stages = {f"sensor_{k}": kernel_count(lambda fn=fn: fn(m, fwd))
            for k, fn in (("pos", sensor.sensor_pos),
                          ("vel", sensor.sensor_vel),
                          ("acc", sensor.sensor_acc))}
  sensor_launches = per_step["sensors"] - per_step["no_sensors"]
  act_launches = per_step["no_sensors"] - per_step["flagship"]
  print(f"humanoid_sensors: device kernels of one step {per_step}: the "
        f"sensor stages' {sensor_launches} (one call each: {stages}), the "
        f"activations' {act_launches} (sensors disabled against the "
        f"flagship)", flush=True)
  run = dict(batch=B, nstep=SENSOR_NSTEP, wall_s=wall, env_steps_per_s=sps,
              launches=launches, launches_per_step=run_launches,
              touch_share=touch_share, peak_memory_bytes=peak, profile=prof,
              profile_sensors_disabled=prof_off,
              step_kernels=per_step,
              sensor_launches_per_step=sensor_launches,
              activation_launches_per_step=act_launches,
              sensor_stage_launches=stages)
  del out, fwd

  judged = {"humanoid_sensors": sensor_card_vs_cpu(
      "humanoid_sensors", 8, SENSOR_CHECK_NSTEP,
      lambda mm, dev: sensor_batch(mm, 8, 71, dev, FEET_IN_FLOOR))}
  print(f"humanoid_sensors: {SENSOR_CHECK_NSTEP} steps f64 B8, each from "
        f"the CPU's state, card = CPU (qpos, qvel, act, sensordata 1e-8; "
        f"{judged['humanoid_sensors']} env-steps judged by last-bit copies)",
        flush=True)
  # the five small scenes of zoo.SENSORS, after humanoid_sensors
  for name in zoo.SENSORS[1:]:
    judged[name] = sensor_card_vs_cpu(
        name, 64, SENSOR_SMALL_NSTEP,
        lambda mm, dev: sensor_batch(mm, 64, 72, dev))
    print(f"{name}: {SENSOR_SMALL_NSTEP} steps f64 B64, card = CPU (qpos, "
          f"qvel, act, sensordata 1e-8; {judged[name]} env-steps judged)",
          flush=True)
  details["sensors"] = dict(humanoid_sensors=run, card_vs_cpu_judged=judged)
  for k in ("ldl_solve", "newton_pyramidal"):
    report[k].setdefault("launches_by_path", {})["humanoid_sensors"] = (
        launches[k])


# ---- the rest of the actuators, sensors and passive forces: phase 25

ACTUATION_NSTEP = 50
ACTUATION_CHECK_NSTEP = 20
# cut from 10 when phase 28 came, to keep the script in its time
ACTUATION_SMALL_NSTEP = 5
# the stand keyframe's trunk is this far above where the quadruped stands
# with its joints at the keyframe's angles (0.2393 m; quadruped_stand.py)
QUAD_DROP = 0.2
ACTUATION_FIELDS = ("qpos", "qvel", "act", "history", "sensordata")


def quadruped_batch(m, nbatch, seed, device="cuda"):
  """The stand keyframe lowered by QUAD_DROP onto the floor (its contacts
  act from the first step), 0.01·N(0, 1) qpos noise, and ctrl the
  keyframe's joint angles plus 0.1·N(0, 1), from a numpy seed."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.parallel import rollout
  d = rollout.make_batch(m, nbatch, device=device)
  rng = np.random.default_rng(seed)
  stand = np.array(zoo.QUADRUPED_STAND)
  stand[2] -= QUAD_DROP
  t = lambda a: torch.tensor(a, dtype=m.dtype, device=device)
  return d.replace(
      qpos=t(stand + 0.01 * rng.standard_normal(tuple(d.qpos.shape))),
      ctrl=t(stand[7:] + 0.1 * rng.standard_normal(tuple(d.ctrl.shape))))


def without_delays(m, history=True):
  """A copy of m with every actuator and sensor delay 0 (the buffers stay
  and are still filled), or, with history False, no buffer in use (Data
  keeps its history words, which nothing reads or writes)."""
  zero = lambda a: np.zeros_like(np.asarray(a))
  m = m.replace(actuator_delay=zero(m.actuator_delay),
                sensor_delay=zero(m.sensor_delay))
  if history:
    return m
  return m.replace(actuator_history=zero(m.actuator_history),
                   sensor_history=zero(m.sensor_history),
                   sensor_interval=zero(m.sensor_interval))


def path_kernels_gate(m64, tag="quadruped_sim2real", step=None, d=None):
  """The LDL and Newton kernels on the arguments one stage-path step of
  m64 (f64) gives them at B 3072 (``step(d)``, by default
  ``forward.step`` from the quadruped's start), against their plain
  versions: the LDL elementwise at f64 and by backward error at f32
  (``ldl_gate``), the Newton kernel at the model's iterations by phase
  11's rule (``newton_rows_gate``)."""
  from mujoco_tpu_torch.ops import forward, linalg_cuda, newton_cuda
  if step is None:
    step, d = lambda dd: forward.step(m64, dd), quadruped_batch(m64, B, 83)
  ldl_args, newton_args = [], []
  spd, run = linalg_cuda.spd_solve, newton_cuda.run

  def spd_rec(h, g):
    ldl_args.append((h, g))
    return spd(h, g)

  def run_rec(args, iterations, ls_iter):
    newton_args.append(args)
    return run(args, iterations, ls_iter)

  linalg_cuda.spd_solve, newton_cuda.run = spd_rec, run_rec
  try:
    step(d)
  finally:
    linalg_cuda.spd_solve, newton_cuda.run = spd, run
  if (len(ldl_args), len(newton_args)) != (1, 1):
    raise AssertionError(f"a step made {len(ldl_args)} LDL and "
                         f"{len(newton_args)} Newton solves")
  h, g = ldl_args[0]
  ldl_err = {str(dt)[6:]: ldl_gate(f"{tag}'s qM", h.to(dt), g.to(dt))
             for dt in (torch.float64, torch.float32)}
  args = newton_args[0]
  it, ls = int(m64.opt.iterations), int(m64.opt.ls_iterations)
  out_k = newton_cuda.newton_kernel(*args, it, ls)
  torch.cuda.synchronize()
  out_p = newton_cuda.newton_plain(*args, it, ls)
  viol = newton_violation(out_k, out_p)
  off, worst_other, table = newton_rows_gate(args, out_k, out_p, it, ls)
  unmatched = [row for row in table if row[1] == 0]
  print(f"newton rows {tag}: nefc {m64.efc.nefc}, nv "
        f"{m64.nv}; f64 B{B} it{it} ls{ls} worst err / (1e-9 + "
        f"1e-9·|plain|) " + " ".join(f"{k} {v:.3f}" for k, v in viol.items())
        + f"; {len(off)} envs off elementwise, replayed {table}", flush=True)
  if len(off) > B // 100 or not worst_other <= 1.0 or unmatched:
    raise AssertionError(f"newton rows {tag}: kernel and plain disagree")
  return dict(ldl_abs_err=ldl_err, newton_violation=viol, off_envs=off,
              replay=table)


def phase_actuation(report, details):
  """25: the rest of the actuators, sensors and passive forces:
  quadruped_sim2real (DC motors in position mode behind an 8 ms action
  delay, a delayed IMU, foot contact sensors, a 15-ray height scan; the
  megastep must refuse it) at f32, B 3072, 50 steps on the stage path;
  the launches of its sensor stages and of the history; card against CPU
  at f64 for it, the ten small scenes of zoo.ACTUATION and the SO3 and
  PID scenes of zoo.ACTUATION_CARRIED."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.models.types import DisableBit, SensorType
  from mujoco_tpu_torch.ops import forward, megastep_cuda
  m = zoo.load("quadruped_sim2real", torch.float32)
  if megastep_cuda.supported(m):
    raise AssertionError("the megastep admits quadruped_sim2real")
  d0 = quadruped_batch(m, B, 80)
  torch.cuda.reset_peak_memory_stats()
  out, wall, launches = stage_run(m, d0, ACTUATION_NSTEP)
  peak = torch.cuda.max_memory_allocated()
  finite = all(bool(torch.isfinite(getattr(out, f)).all())
               for f in ("qpos", "qvel", "act", "history"))
  # scan_steps keeps the state alone: the sensors of the final state are
  # a forward pass's
  fwd = forward.forward(m, out)
  finite &= bool(torch.isfinite(fwd.sensordata).all())
  st, adr = np.asarray(m.sensor_type), np.asarray(m.sensor_adr)
  scan = fwd.sensordata[:, adr[st == SensorType.RANGEFINDER]]
  rays_hit = bool((scan > 0).all())
  found = fwd.sensordata[:, adr[st == SensorType.CONTACT]]
  contact_share = (found > 0).any(-1).double().mean().item()
  height = fwd.qpos[:, 2].double()
  run_launches = {k: v / ACTUATION_NSTEP for k, v in launches.items()}
  sps = B * ACTUATION_NSTEP / wall
  print(f"quadruped_sim2real (nv {m.nv}, na {m.na}, nhistory {m.nhistory}, "
        f"{m.nsensor} sensors, {m.nsensordata} values): f32 B{B} "
        f"{ACTUATION_NSTEP} steps from the stand keyframe lowered "
        f"{QUAD_DROP}: wall {wall:.3f} s, {sps:.1f} env-steps/s, kernel "
        f"launches per step {run_launches}, finite {finite}, every ray hit "
        f"{rays_hit} (shortest {scan.min().item():.4f} m), share of envs "
        f"with a foot contact {contact_share:.4f}, trunk height mean "
        f"{height.mean().item():.4f} m, lowest {height.min().item():.4f} m, "
        f"peak memory {peak / 2**30:.2f} GiB", flush=True)
  if (not finite or launches["ldl_solve"] != ACTUATION_NSTEP
      or launches["newton_pyramidal"] != ACTUATION_NSTEP
      or launches["megastep"] or not rays_hit or not contact_share > 0):
    raise AssertionError(f"quadruped_sim2real: finite {finite}, launches "
                         f"{launches}, rays hit {rays_hit}, contact share "
                         f"{contact_share}")
  m_off = m.replace(opt=m.opt.replace(
      disableflags=int(m.opt.disableflags) | int(DisableBit.SENSOR)))
  variants = (("as built", m), ("sensors disabled", m_off),
              ("delays 0", without_delays(m)),
              ("no history", without_delays(m, history=False)))
  profiles, per_step = {}, {}
  for tag, mm in variants:
    # a profiled window as built, with the sensors off and with the delays
    # 0; one step's kernels for all four, the most of 3 profiled calls
    # (the phase stays within 60 s)
    if tag != "no history":
      profiles[tag] = profiled(mm, out, 2)
      print_profile(f"quadruped_sim2real, {tag}, f32 B{B} 2 steps",
                    profiles[tag])
    per_step[tag] = kernel_count(lambda mm=mm: forward.step(mm, out),
                                 attempts=3)
  sensor_launches = per_step["as built"] - per_step["sensors disabled"]
  delay_launches = per_step["as built"] - per_step["delays 0"]
  history_launches = per_step["as built"] - per_step["no history"]
  print(f"quadruped_sim2real: device kernels of one step {per_step}: the "
        f"sensor stages' {sensor_launches}, the delays' {delay_launches}, "
        f"the history buffers' with the delays {history_launches}",
        flush=True)
  run = dict(batch=B, nstep=ACTUATION_NSTEP, wall_s=wall,
             env_steps_per_s=sps, launches=launches,
             launches_per_step=run_launches, contact_share=contact_share,
             rays_hit=rays_hit, peak_memory_bytes=peak, profiles=profiles,
             step_kernels=per_step,
             sensor_launches_per_step=sensor_launches,
             delay_launches_per_step=delay_launches,
             history_launches_per_step=history_launches)
  del out, fwd
  run["path_kernels"] = path_kernels_gate(
      zoo.load("quadruped_sim2real", torch.float64))

  judged = {"quadruped_sim2real": sensor_card_vs_cpu(
      "quadruped_sim2real", 8, ACTUATION_CHECK_NSTEP,
      lambda mm, dev: quadruped_batch(mm, 8, 81, dev), ACTUATION_FIELDS)}
  print(f"quadruped_sim2real: {ACTUATION_CHECK_NSTEP} steps f64 B8, each "
        f"from the CPU's state, card = CPU (qpos, qvel, act, history, "
        f"sensordata 1e-8; {judged['quadruped_sim2real']} env-steps judged "
        f"by last-bit copies)", flush=True)
  for name in zoo.ACTUATION[1:] + zoo.ACTUATION_CARRIED:
    judged[name] = sensor_card_vs_cpu(
        name, 64, ACTUATION_SMALL_NSTEP,
        lambda mm, dev: sensor_batch(mm, 64, 82, dev), ACTUATION_FIELDS)
    print(f"{name}: {ACTUATION_SMALL_NSTEP} steps f64 B64, card = CPU "
          f"(qpos, qvel, act, history, sensordata 1e-8; {judged[name]} "
          f"env-steps judged)", flush=True)
  details["actuation"] = dict(quadruped_sim2real=run,
                              card_vs_cpu_judged=judged)
  for k in ("ldl_solve", "newton_pyramidal"):
    report[k].setdefault("launches_by_path", {})["quadruped_sim2real"] = (
        launches[k])


CONTROL_NSTEP = 20
TRANSITION_B = 256
TRANSITION_CHECK_B = 8


def control_state(m, nbatch, seed, device="cuda"):
  """The humanoid at the main path's start made from a numpy seed (qpos
  0.01·N(0, 1) from qpos0, qvel 0.1·N(0, 1), ctrl 0.2·N(0, 1), qacc
  2·N(0, 1)): the same values on any device."""
  from mujoco_tpu_torch.parallel import rollout
  d = rollout.make_batch(m, nbatch, device=device)
  rng = np.random.default_rng(seed)
  t = lambda a: torch.tensor(a, dtype=m.dtype, device=device)
  shape = lambda f: tuple(getattr(d, f).shape)
  return d.replace(
      qpos=d.qpos + t(0.01 * rng.standard_normal(shape("qpos"))),
      qvel=t(0.1 * rng.standard_normal(shape("qvel"))),
      ctrl=t(0.2 * rng.standard_normal(shape("ctrl"))),
      qacc=t(2.0 * rng.standard_normal(shape("qacc"))))


def host_us(fn, reps=20) -> float:
  """Host-clock µs per synchronized call of fn (after one warm call)."""
  fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(reps):
    fn()
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) / reps * 1e6


def gate_close(tag, a, b, tol):
  """|a − b| ≤ tol + tol·|b| elementwise (b the CPU's); returns the worst
  violation ratio."""
  a, b = a.cpu().double(), b.cpu().double()
  if a.shape != b.shape:
    raise AssertionError(f"{tag}: shapes {tuple(a.shape)}, {tuple(b.shape)}")
  if not a.numel():
    return 0.0
  worst = ((a - b).abs() / (tol + tol * b.abs())).max().item()
  if not worst <= 1.0:
    raise AssertionError(f"{tag}: card and CPU differ ({worst} × limit)")
  return worst


def control_state_phase():
  """26a: reset to the quadruped's stand keyframe and a state-vector round
  trip under INTEGRATION at f32, B 3072, card against CPU bit for bit."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import state
  from mujoco_tpu_torch.parallel import rollout
  spec = int(state.StateBit.INTEGRATION)
  vecs, times = {}, {}
  for dev in ("cuda", "cpu"):
    m = zoo.quadruped(torch.float32, device=dev)
    key = state.name2id(m, "key", "stand")
    d = state.reset_data_keyframe(m, rollout.make_batch(m, B, device=dev),
                                  key)
    stand = torch.tensor(zoo.QUADRUPED_STAND, dtype=torch.float32,
                         device=dev)
    if d.qpos.device.type != dev or not bool((d.qpos == stand).all()):
      raise AssertionError(f"reset_data_keyframe on {dev}: device "
                           f"{d.qpos.device}, qpos {d.qpos[0].tolist()}")
    rng = np.random.default_rng(90)
    d = d.replace(qvel=torch.tensor(rng.standard_normal(
        tuple(d.qvel.shape)), dtype=torch.float32, device=dev))
    vec = state.get_state(m, d, spec)
    back = state.set_state(m, state.reset_data(m, d), spec, vec)
    for bit, name, _ in state._COMPONENTS:
      if not torch.equal(getattr(back, name), getattr(d, name)):
        raise AssertionError(f"set_state(get_state) on {dev}: {name}")
    vecs[dev] = vec.cpu()
    if dev == "cuda":
      times = dict(
          reset_data_keyframe_us=host_us(
              lambda: state.reset_data_keyframe(m, d, key)),
          get_state_us=host_us(lambda: state.get_state(m, d, spec)),
          set_state_us=host_us(lambda: state.set_state(m, d, spec, vec)))
  if not torch.equal(vecs["cuda"], vecs["cpu"]):
    raise AssertionError("get_state: card and CPU vectors differ")
  print(f"state: quadruped f32 B{B}, reset to keyframe 'stand' "
        f"(id {key}), INTEGRATION vector of {vecs['cpu'].shape[1]} values "
        f"per env: round trip exact, card = CPU bit for bit; µs per call "
        + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in times.items()),
        flush=True)
  return dict(size=int(vecs["cpu"].shape[1]), **times)


def control_inverse_phase(report):
  """26b: inverse dynamics of the humanoid at f64, B 3072, card against
  CPU (1e-8), compare_fwd_inv's norms after a forward pass, and the
  discrete inverse (INVDISCRETE, implicitfast) through the LDL kernel."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.models.types import EnableBit, Integrator
  from mujoco_tpu_torch.ops import forward, inverse
  out, worst = {}, {}
  discrete = {"integrator": int(Integrator.IMPLICITFAST),
              "enableflags": int(EnableBit.INVDISCRETE)}
  for tag, opt in (("euler", None), ("implicitfast_invdiscrete", discrete)):
    res = {}
    for dev in ("cuda", "cpu"):
      m = zoo.load("humanoid", torch.float64, device=dev, opt=opt)
      d = control_state(m, B, 91, dev)
      torch.cuda.synchronize()
      reset_counts()
      res[dev] = inverse.inverse(m, d)
      torch.cuda.synchronize()
      if dev == "cuda":
        launches = read_counts()
    worst[tag] = gate_close(f"inverse {tag}", res["cuda"].qfrc_inverse,
                            res["cpu"].qfrc_inverse, 1e-8)
    want_ldl = 1 if opt else 0
    if (launches["ldl_solve"] != want_ldl or launches["newton_pyramidal"]
        or launches["megastep"]):
      raise AssertionError(f"inverse {tag}: launches {launches}")
    out[tag] = dict(worst=worst[tag], launches=launches)
    if opt:
      report["ldl_solve"].setdefault("launches_by_path", {})[
          "discrete_acc"] = launches["ldl_solve"]
  m = zoo.humanoid(torch.float64)
  d = forward.forward(m, control_state(m, B, 92))
  dif1, dif2 = inverse.compare_fwd_inv(m, d)
  norms = {k: dict(max=v.max().item(), median=v.median().item())
           for k, v in (("constraint", dif1), ("force", dif2))}
  print(f"inverse: humanoid f64 B{B}, card vs CPU worst err / (1e-8 + "
        f"1e-8·|CPU|) {worst['euler']:.3f}; implicitfast with INVDISCRETE "
        f"{worst['implicitfast_invdiscrete']:.3f}, LDL launches "
        f"{out['implicitfast_invdiscrete']['launches']['ldl_solve']}; "
        f"compare_fwd_inv after forward: constraint "
        f"{norms['constraint']['max']:.3e} (median "
        f"{norms['constraint']['median']:.3e}), force "
        f"{norms['force']['max']:.3e} (median "
        f"{norms['force']['median']:.3e})", flush=True)
  return dict(cases=out, compare_fwd_inv=norms)


def control_transition_phase(report):
  """26c: transition Jacobians of the humanoid: the LDL and Newton
  kernels' launches and ms per env at f32, B 256; f64 card against CPU on
  8 envs (1e-7); the card's A against its own centered transition_fd at
  f64 (eps 1e-6, 1e-4)."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import derivative_fd
  m = zoo.humanoid(torch.float32)
  d = control_state(m, TRANSITION_B, 93)
  torch.cuda.synchronize()
  reset_counts()
  t0 = time.perf_counter()
  a, b, _, _ = derivative_fd.transition(m, d)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = read_counts()
  finite = bool(torch.isfinite(a).all() & torch.isfinite(b).all())
  if (not finite or not launches["ldl_solve"] > 0
      or not launches["newton_pyramidal"] > 0 or launches["megastep"]):
    raise AssertionError(f"transition f32: finite {finite}, launches "
                         f"{launches}")
  wall2 = host_us(lambda: derivative_fd.transition(m, d), reps=2) / 1e6
  ndir = 2 * m.nv + m.na + m.nctrl
  for k in ("ldl_solve", "newton_pyramidal"):
    report[k].setdefault("launches_by_path", {})["transition"] = launches[k]
  outs = {}
  for dev in ("cuda", "cpu"):
    m64 = zoo.humanoid(torch.float64, device=dev)
    outs[dev] = derivative_fd.transition(
        m64, control_state(m64, TRANSITION_CHECK_B, 94, dev))
  worst = max(gate_close(f"transition {n}", x, y, 1e-7)
              for n, x, y in zip("ABCD", outs["cuda"], outs["cpu"]))
  m64 = zoo.humanoid(torch.float64)
  d64 = control_state(m64, TRANSITION_B, 93)
  a64 = derivative_fd.transition(m64, d64)[0]
  a_fd = derivative_fd.transition_fd(m64, d64, eps=1e-6, centered=True)[0]
  fd_err = (a64 - a_fd).abs().max().item()
  print(f"transition: humanoid ({ndir} directions: B·{ndir} copies in one "
        f"step) f32 B{TRANSITION_B}: first call {wall:.3f} s, then "
        f"{wall2:.3f} s, {wall2 / TRANSITION_B * 1e3:.3f} ms per env, "
        f"launches {launches}; f64 B{TRANSITION_CHECK_B} card vs CPU worst "
        f"err / (1e-7 + 1e-7·|CPU|) {worst:.3f}; f64 B{TRANSITION_B} A "
        f"against centered transition_fd (eps 1e-6) max |diff| "
        f"{fd_err:.3e} (limit 1e-4)", flush=True)
  if not fd_err <= 1e-4:
    raise AssertionError(f"transition: A and its FD differ by {fd_err}")
  out = dict(batch=TRANSITION_B, directions=ndir, first_wall_s=wall,
             wall_s=wall2, ms_per_env=wall2 / TRANSITION_B * 1e3,
             launches=launches, card_vs_cpu_worst=worst,
             fd_max_abs_diff=fd_err)
  out["per_env_model"] = transition_case(report, "humanoid", True)
  out["tendon_rows"] = transition_case(report, "tendon_rows", False)
  return out


def transition_case(report, name, per_env):
  """``transition`` of the scene ``name``, its Model per env (every
  admitted leaf, ``control_leaves``) where asked: f32, B 256, finite, its
  launches and ms per env; f64, B 8, card against CPU (1e-7)."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import derivative_fd
  from mujoco_tpu_torch.parallel import rollout
  tag = f"{name}{' per env' if per_env else ''}"

  def model(dtype, nbatch, dev="cuda"):
    m = zoo.load(name, dtype, device=dev)
    if per_env:
      m = rollout.randomize_model(m, control_leaves(m, nbatch, 97))[0]
    return m

  m = model(torch.float32, TRANSITION_B)
  d = control_state(m, TRANSITION_B, 93)
  torch.cuda.synchronize()
  reset_counts()
  a, b, _, _ = derivative_fd.transition(m, d)
  torch.cuda.synchronize()
  launches = read_counts()
  finite = bool(torch.isfinite(a).all() & torch.isfinite(b).all())
  if not finite or not launches["ldl_solve"] > 0 or launches["megastep"]:
    raise AssertionError(f"transition {tag} f32: finite {finite}, "
                         f"launches {launches}")
  wall = host_us(lambda: derivative_fd.transition(m, d), reps=2) / 1e6
  outs = {}
  for dev in ("cuda", "cpu"):
    m64 = model(torch.float64, TRANSITION_CHECK_B, dev)
    outs[dev] = derivative_fd.transition(
        m64, control_state(m64, TRANSITION_CHECK_B, 94, dev))
  worst = max(gate_close(f"transition {tag} {n}", x, y, 1e-7)
              for n, x, y in zip("ABCD", outs["cuda"], outs["cpu"]))
  key = "transition_per_env" if per_env else f"transition_{name}"
  for k in ("ldl_solve", "newton_pyramidal"):
    report[k].setdefault("launches_by_path", {})[key] = launches[k]
  print(f"transition: {tag} (nv {m.nv}, "
        f"{len(m.env_leaves)} per-env leaves) f32 B{TRANSITION_B}: "
        f"{wall:.3f} s, {wall / TRANSITION_B * 1e3:.3f} ms per env, "
        f"launches {launches}; f64 B{TRANSITION_CHECK_B} card vs CPU worst "
        f"err / (1e-7 + 1e-7·|CPU|) {worst:.3f}", flush=True)
  return dict(batch=TRANSITION_B, wall_s=wall,
              ms_per_env=wall / TRANSITION_B * 1e3, launches=launches,
              card_vs_cpu_worst=worst)


# the leaves a sim-to-real user draws per env on quadruped_sim2real
SIM2REAL_LEAVES = ("geom_friction", "geom_solref", "body_mass", "body_ipos",
                   "actuator_gear", "actuator_gainprm", "actuator_biasprm",
                   "dof_damping", "dof_armature", "dof_frictionloss", "qpos0",
                   "opt.timestep")
SIM2REAL_CHECK_NSTEP = 10


def control_leaves(m, nbatch, seed, leaves=None):
  """Per-env values of the admitted leaves (every one by default), drawn
  from a numpy seed by ``rollout.draw_leaves``'s rule for each, as tensors
  on m's device."""
  from mujoco_tpu_torch.parallel import rollout
  return {k: torch.tensor(v, dtype=m.dtype, device=m.device)
          for k, v in rollout.draw_leaves(m, nbatch, seed, leaves).items()}


def randomized_card_vs_cpu(bm_card, bm_cpu, d, nstep, fields):
  """nstep steps at f64 of a per-env Model (bm_card on the card, bm_cpu
  its copy on the CPU), each step of the CPU's state on both: ``fields``
  within 1e-8 absolute plus relative, an env that misses judged by
  last-bit copies of its state (qpos, qvel, act), each copy with its
  env's leaves, on both sides (judge_envs). Returns (the env-steps
  judged, the CPU's state after the nstep steps)."""
  from mujoco_tpu_torch.ops import forward
  judged = 0
  for _ in range(nstep):
    out_h = forward.step(bm_cpu, d)
    out_c = forward.step(bm_card, d.to("cuda"))

    def rerun(idx, bm, d=d):
      k = SCENE_COPIES
      rep = idx.repeat_interleave(k)
      gen = torch.Generator().manual_seed(0)
      copies = take_envs(d, rep)
      moved = {f: getattr(copies, f) * (1 + last_bits(
          getattr(copies, f).shape, gen)) for f in ("qpos", "qvel", "act")}
      r = forward.step(bm.envs(rep.to(bm.device)),
                       copies.replace(**moved).to(bm.device))
      return [getattr(r, f).reshape((len(idx), k) + getattr(r, f).shape[1:])
              for f in fields]

    judged += judge_envs([getattr(out_c, f)[None] for f in fields],
                         [getattr(out_h, f)[None] for f in fields],
                         lambda idx: rerun(idx, bm_cpu),
                         lambda idx: rerun(idx, bm_card), SCENE_COPIES, 1e-8,
                         1.0)
    d = out_h
  return judged, d


def step_loop(fn, d, nstep):
  """nstep steps d = fn(d) with the launch counts zeroed just before and
  read just after; returns (out, wall s, launches)."""
  torch.cuda.synchronize()
  reset_counts()
  t0 = time.perf_counter()
  for _ in range(nstep):
    d = fn(d)
  torch.cuda.synchronize()
  return d, time.perf_counter() - t0, read_counts()


def control_randomized_phase(report):
  """26d: all eighteen leaves per env on the humanoid, B 3072: 20 steps
  f64 card = CPU (1e-8, each step from the CPU's state, envs judged by
  last-bit copies); 4 envs of the card's own 20 steps each equal to a
  plain Model that holds its leaves (1e-8); env-steps/s at f32 beside the
  plain stage path's."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward, megastep_cuda
  from mujoco_tpu_torch.parallel import rollout
  bms = {}
  for dev in ("cuda", "cpu"):
    m = zoo.humanoid(torch.float64, device=dev)
    bms[dev], axes = rollout.randomize_model(m, control_leaves(m, B, 95))
  judged, _ = randomized_card_vs_cpu(bms["cuda"], bms["cpu"],
                                     control_state(m, B, 96, "cpu"),
                                     CONTROL_NSTEP, ("qpos", "qvel"))
  m, bm = zoo.humanoid(torch.float64), bms["cuda"]
  start = control_state(m, B, 96)
  d_rand = start
  for _ in range(CONTROL_NSTEP):
    d_rand = rollout.step_randomized(bm, axes, d_rand)
  single = 0.0
  for i in (0, 1, B // 3, B - 1):
    plain = bm.envs(i)
    if plain.env_leaves:
      raise AssertionError(f"env {i}'s Model keeps per-env leaves")
    di = take_envs(start, torch.tensor([i], device="cuda"))
    for _ in range(CONTROL_NSTEP):
      di = forward.step(plain, di)
    single = max(single, max(gate_close(
        f"randomized env {i} {k}", getattr(di, k)[0],
        getattr(d_rand, k)[i], 1e-8) for k in ("qpos", "qvel")))
  del bms, bm, d_rand
  m32 = zoo.humanoid(torch.float32)
  bm32, axes = rollout.randomize_model(m32, control_leaves(m32, B, 95))
  if megastep_cuda.supported(bm32):
    raise AssertionError("the megastep admits a per-env Model")
  d32 = main_path_batch(m32)
  out_r, wall_r, launches_r = stage_run(bm32, d32, CONTROL_NSTEP)
  with stage_path():
    out_p, wall_p, launches_p = stage_run(m32, d32, CONTROL_NSTEP)
  finite = all(bool(torch.isfinite(o.qpos).all()) for o in (out_r, out_p))
  if (not finite or launches_r != {"ldl_solve": CONTROL_NSTEP,
                                   "newton_pyramidal": CONTROL_NSTEP,
                                   "megastep": 0}):
    raise AssertionError(f"randomized f32: finite {finite}, launches "
                         f"{launches_r}")
  kernels_r = kernel_count(lambda: rollout.step_randomized(bm32, axes,
                                                           out_r), 3)
  kernels_p = kernel_count(lambda: forward.step(m32, out_p), 3)
  sps_r, sps_p = B * CONTROL_NSTEP / wall_r, B * CONTROL_NSTEP / wall_p
  for k in ("ldl_solve", "newton_pyramidal"):
    report[k].setdefault("launches_by_path", {})["randomized"] = (
        launches_r[k])
  print(f"randomized: humanoid, all {len(bm32.env_leaves)} leaves per env, "
        f"f64 B{B} {CONTROL_NSTEP} steps card = CPU (1e-8; {judged} "
        f"env-steps judged by last-bit copies), 4 envs against a plain "
        f"Model of their leaves, worst err / (1e-8 + 1e-8·|value|) "
        f"{single:.3f}; f32 B{B} {CONTROL_NSTEP} steps: randomized "
        f"{sps_r:.1f} env-steps/s ({launches_r['ldl_solve'] / CONTROL_NSTEP}"
        f" LDL and {launches_r['newton_pyramidal'] / CONTROL_NSTEP} Newton "
        f"launches and {kernels_r} device kernels per step), plain stage "
        f"path {sps_p:.1f} ({kernels_p} device kernels per step)",
        flush=True)
  return dict(leaves=len(bm32.env_leaves), card_vs_cpu_judged=judged,
              single_env_worst=single, env_steps_per_s=sps_r,
              plain_env_steps_per_s=sps_p, launches=launches_r,
              plain_launches=launches_p, kernels_per_step=kernels_r,
              plain_kernels_per_step=kernels_p)


def control_sim2real_phase(report):
  """26e: quadruped_sim2real at implicitfast with the leaves of
  SIM2REAL_LEAVES drawn per env: 20 steps of ``step_randomized`` at f32,
  B 3072, from the phase 25 start (finite, one LDL and one Newton launch
  per step, env-steps/s beside the plain stage path's); 10 steps at f64,
  B 8, card = CPU. Implicitfast is the integrator of MuJoCo's own
  quadruped models. Under the scene's Euler a draw of ×[0.7, 1.3] on the
  motors' gear or gain or on the timestep makes the back-EMF damping's
  explicit step unstable: 20-51 of 64 envs diverge within 20 steps (27
  still at ×[0.9, 1.1]), the same envs in the reference as in the port
  (tests/torch_sim2real_euler.py, f64 on the CPU)."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.models.types import Integrator
  from mujoco_tpu_torch.ops import forward, megastep_cuda
  from mujoco_tpu_torch.parallel import rollout
  opt = {"integrator": int(Integrator.IMPLICITFAST)}
  m = zoo.load("quadruped_sim2real", torch.float32, opt=opt)
  bm, axes = rollout.randomize_model(m, control_leaves(m, B, 98,
                                                       SIM2REAL_LEAVES))
  if megastep_cuda.supported(bm):
    raise AssertionError("the megastep admits a per-env quadruped")
  d0 = quadruped_batch(m, B, 99)
  step_r = lambda d: rollout.step_randomized(bm, axes, d)
  out_r, wall_r, launches_r = step_loop(step_r, d0, CONTROL_NSTEP)
  out_p, wall_p, launches_p = step_loop(lambda d: forward.step(m, d), d0,
                                        CONTROL_NSTEP)
  finite = all(bool(torch.isfinite(getattr(o, f)).all())
               for o in (out_r, out_p) for f in ("qpos", "qvel", "act"))
  want = {"ldl_solve": CONTROL_NSTEP, "newton_pyramidal": CONTROL_NSTEP,
          "megastep": 0}
  if not finite or launches_r != want or launches_p != want:
    raise AssertionError(f"sim2real f32: finite {finite}, launches "
                         f"{launches_r}, plain {launches_p}")
  kernels_r = kernel_count(lambda: step_r(out_r), 3)
  kernels_p = kernel_count(lambda: forward.step(m, out_p), 3)
  sps_r, sps_p = B * CONTROL_NSTEP / wall_r, B * CONTROL_NSTEP / wall_p
  bms = {}
  for dev in ("cuda", "cpu"):
    m64 = zoo.load("quadruped_sim2real", torch.float64, device=dev, opt=opt)
    bms[dev] = rollout.randomize_model(m64, control_leaves(
        m64, 8, 98, SIM2REAL_LEAVES))[0]
  judged, _ = randomized_card_vs_cpu(
      bms["cuda"], bms["cpu"], quadruped_batch(m64, 8, 99, "cpu"),
      SIM2REAL_CHECK_NSTEP, ACTUATION_FIELDS)
  for k in ("ldl_solve", "newton_pyramidal"):
    report[k].setdefault("launches_by_path", {})["randomized_sim2real"] = (
        launches_r[k])
  print(f"randomized: quadruped_sim2real at implicitfast, "
        f"{len(bm.env_leaves)} leaves per "
        f"env ({', '.join(bm.env_leaves)}), f32 B{B} {CONTROL_NSTEP} steps "
        f"of step_randomized: {sps_r:.1f} env-steps/s "
        f"({launches_r['ldl_solve'] / CONTROL_NSTEP} LDL and "
        f"{launches_r['newton_pyramidal'] / CONTROL_NSTEP} Newton launches "
        f"and {kernels_r} device kernels per step), plain stage path "
        f"{sps_p:.1f} ({kernels_p} device kernels per step), finite "
        f"{finite}; f64 B8 {SIM2REAL_CHECK_NSTEP} steps card = CPU (1e-8 "
        f"on {', '.join(ACTUATION_FIELDS)}; {judged} env-steps judged by "
        f"last-bit copies)", flush=True)
  return dict(leaves=list(bm.env_leaves), env_steps_per_s=sps_r,
              plain_env_steps_per_s=sps_p, launches=launches_r,
              plain_launches=launches_p, kernels_per_step=kernels_r,
              plain_kernels_per_step=kernels_p, card_vs_cpu_judged=judged)


def phase_control_loop(report, details):
  """26: the control-loop API: state vectors and keyframe resets,
  inverse dynamics, transition Jacobians by forward-mode AD through the
  LDL and Newton kernels (of a per-env Model and through tendon armature
  too), and a per-env (domain-randomized) Model on the humanoid and the
  sim-to-real quadruped."""
  details["control_loop"] = dict(
      state=control_state_phase(),
      inverse=control_inverse_phase(report),
      transition=control_transition_phase(report),
      randomized=control_randomized_phase(report),
      sim2real=control_sim2real_phase(report))


FLEX_CHECK_NSTEP = 10
# phase 27's own card-against-CPU depth, cut from FLEX_CHECK_NSTEP when
# phase 28 came, to keep the script in its time (the card tests keep 10)
FLEX_PHASE_NSTEP = 5
FLEX_NSTEP = 20
FLEX_CHECK_B = 8
# scene → (flex z shift, free bodies' z, qpos noise): a start whose
# contacts act within the run (tests/test_torch_flex_scenes.py START)
FLEX_START = {
    "humanoid_hammock": (0.0, 0.68, 0.01),
    "cloth_pinned": (0.0, None, 0.01),
    "cloth_bodies": (0.0, 0.38, 0.01),
    "cloth_plane_drop": (-0.79, None, 0.005),
    "cable_springs": (0.0, None, 0.02),
    "rope_floor": (-0.14, None, 0.005),
    "rope_bodies": (0.0, 0.18, 0.01),
    "cloth_elastic": (0.0, None, 0.01),
    "gel_plane_drop": (-0.17, None, 0.003),
    "gel_trilinear": (-0.15, None, 0.005),
    "gel_strain": (0.0, None, 0.005),
    "rope_self": (-0.28, None, 0.06),
    "strip_self": (-0.03, None, 0.03),
    "gel_internal": (0.0, 0.17, 0.01),
    "cloth_sleep": (-0.05, None, 0.005),
}


def flex_batch(name, m, nbatch, seed, device="cuda"):
  """make_batch of a zoo.FLEX scene at its FLEX_START from a numpy seed:
  the flex's vertical slides moved by the shift, free roots set to the
  height, qpos noise; the same on the card and the CPU."""
  from mujoco_tpu_torch.parallel import rollout
  shift, drop, noise = FLEX_START[name]
  d = rollout.make_batch(m, nbatch, device=device)
  rng = np.random.default_rng(seed)
  qpos = (d.qpos.cpu().double()
          + torch.as_tensor(noise * rng.standard_normal(tuple(d.qpos.shape))))
  flexbody = np.isin(np.asarray(m.jnt_bodyid), np.concatenate(
      [m.flx.vertbodyid, m.flx.nodebodyid]))
  axis = m.jnt_axis.detach().cpu().numpy()
  for j in range(m.njnt):
    adr = int(m.jnt_qposadr[j])
    if int(m.jnt_type[j]) == 0 and drop is not None:          # free root
      qpos[:, adr + 2] = drop
    elif (int(m.jnt_type[j]) == 2 and flexbody[j]
          and np.allclose(axis[j], [0, 0, 1])):
      qpos[:, adr] += shift
  return d.replace(qpos=qpos.to(device=device, dtype=m.dtype))


def flex_picks(m, d) -> torch.Tensor:
  """(1, B, slots, 8): per env the vertices (flexvert1, flexvert) of each
  flex slot group's slots in contact, in a canonical order (a group's
  equal-distance candidates fill its slots in an order the last bit
  decides), −2 past them; what phase 27 holds card = CPU."""
  con = m.con
  groups = ([(int(a), con.flex_budget) for a in con.flexpair_adr]
            + [(g["adr"], g["npair"]) for g in con.selfgroups]
            + [(g["adr"], g["nslots"])
               for g in con.intgroups + con.evgroups])
  c = d.contact
  live = (c.dist < c.includemargin).cpu().numpy()
  verts = torch.cat([c.flexvert1, c.flexvert], -1).cpu().numpy()
  out = []
  for adr, n in groups:
    sl = slice(adr, adr + n)
    v = np.where(live[:, sl, None], verts[:, sl], 2 ** 20)
    rows = []
    for b in range(v.shape[0]):
      order = np.lexsort(v[b].T[::-1])
      rows.append(np.where(v[b][order] == 2 ** 20, -2, v[b][order]))
    out.append(np.stack(rows))
  if not out:                                   # no flex slot
    return torch.zeros((1, live.shape[0], 0, 8), dtype=torch.float64)
  return torch.as_tensor(np.concatenate(out, 1), dtype=torch.float64)[None]


def flex_card_vs_cpu(name, nstep=FLEX_CHECK_NSTEP):
  """nstep steps at f64, B FLEX_CHECK_B: each step of the CPU's
  state on the card and on the CPU, qpos and qvel within 1e-8 absolute
  plus relative and the vertices of the slots in contact equal
  (``flex_picks``), an env that misses judged by last-bit copies of its
  state on both sides (judge_envs). Returns (env-steps judged, slots in
  contact over the run)."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward
  mc = zoo.load(name, torch.float64, "cuda")
  mh = zoo.load(name, torch.float64, "cpu")
  d = flex_batch(name, mh, FLEX_CHECK_B, 71, "cpu")
  judged = live = 0
  for _ in range(nstep):
    out_h = forward.step(mh, d)
    out_c = forward.step(mc, d.to("cuda"))
    live += int((out_h.contact.dist < out_h.contact.includemargin).sum())

    def rerun(idx, m, d=d):
      k = SCENE_COPIES
      gen = torch.Generator().manual_seed(0)
      copies = take_envs(d, idx.repeat_interleave(k))
      moved = {f: getattr(copies, f) * (1 + last_bits(
          getattr(copies, f).shape, gen)) for f in ("qpos", "qvel")}
      r = forward.step(m, copies.replace(**moved).to(m.device))
      return [x.reshape((len(idx), k) + x.shape[1:])
              for x in (r.qpos, r.qvel, flex_picks(m, r)[0])]

    judged += judge_envs(
        [out_c.qpos[None], out_c.qvel[None], flex_picks(mc, out_c)],
        [out_h.qpos[None], out_h.qvel[None], flex_picks(mh, out_h)],
        lambda idx: rerun(idx, mh), lambda idx: rerun(idx, mc),
        SCENE_COPIES, 1e-8, 1.0)
    d = out_h
  return judged, live


def phase_flex(report, details):
  """27: the flex scenes (zoo.FLEX): the megastep's gate refuses each;
  card = CPU at f64; the LDL kernel on humanoid_hammock's qM at n 258 and
  the Newton kernel on its rows at nv 258 against their plain versions;
  the hammock at full width on the stage path."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import (collision_flex, flex, forward,
                                    linalg_cuda, megastep_cuda, newton_cuda,
                                    smooth, solver)
  from mujoco_tpu_torch.parallel import rollout
  name = "humanoid_hammock"
  load = lambda dtype, dev="cuda": zoo.load(name, dtype, dev)

  # the megastep's gate: every flex scene keeps the stage path
  for scene in zoo.FLEX:
    mm = zoo.load(scene, torch.float32, "cuda")
    dd = rollout.make_batch(mm, 2)
    if megastep_cuda.supported(mm) or rollout.megastep_eligible(
        mm, dd, rollout.make_batch(mm, 1)):
      raise AssertionError(f"the megastep admits {scene}")
  print(f"megastep gate: refuses all {len(zoo.FLEX)} flex scenes",
        flush=True)

  # card = CPU at f64, every scene
  check = {}
  for scene in zoo.FLEX:
    t0 = time.perf_counter()
    judged, live = flex_card_vs_cpu(scene, FLEX_PHASE_NSTEP)
    check[scene] = dict(judged_env_steps=judged, live_slots=live,
                        s=time.perf_counter() - t0)
    print(f"{scene} card vs CPU f64 B{FLEX_CHECK_B} {FLEX_PHASE_NSTEP} "
          f"steps: qpos, qvel within 1e-8 and the vertices of the slots in "
          f"contact equal ({live} slot-steps in contact), env-steps judged "
          f"by last-bit copies {judged} ({check[scene]['s']:.1f} s)",
          flush=True)

  m = load(torch.float32)
  nbatch = fitting_batch(m, lambda mm, n: flex_batch(name, mm, n, 72))

  # the LDL kernel on the hammock's own qM, n 258 (shared memory at f32,
  # the device-memory work space at f64)
  wide = {}
  for dtype in (torch.float32, torch.float64):
    mm = load(dtype)
    d = flex_batch(name, mm, nbatch, 73)
    d = smooth.crb(mm, smooth.com_pos(mm, smooth.kinematics(mm, d)))
    h = d.qM.contiguous()
    gen = torch.Generator(device="cuda").manual_seed(74)
    g = torch.randn(d.qvel.shape, generator=gen, device="cuda", dtype=dtype)
    del d
    route = linalg_cuda.occupancy(h.shape[1], dtype)["route"]
    err = ldl_gate(f"humanoid_hammock's mass matrix ({route})", h, g)
    k_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_kernel(h, g), reps=10)
    p_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_plain(h, g), reps=10)
    lib_ms = cuda_ms_cold(lambda: torch.linalg.solve(h, g), reps=10)
    b_ms, by = ldl_bound(nbatch, h.shape[1], dtype)
    wide[str(dtype)[6:]] = dict(n=h.shape[1], route=route, ms=k_ms,
                                plain_ms=p_ms, library_ms=lib_ms,
                                bound_ms=b_ms, bound_by=by, max_abs_err=err)
    print(f"ldl_solve {str(dtype)[6:]} B{nbatch} n{h.shape[1]} ({route}) "
          f"on the hammock's qM: kernel_ms {k_ms:.4f} (L2 flushed) plain_ms "
          f"{p_ms:.4f} library_ms {lib_ms:.4f} (torch.linalg.solve) "
          f"bound_ms {b_ms:.5f} ({by})", flush=True)
    del h, g

  # the Newton kernel on the hammock's rows (its cloth, floor and limit
  # rows): f64 B 256 under phase 11's rule, f32 at the full width under
  # phase 6's
  def rows_state(mm, nb, seed):
    d = flex_batch(name, mm, nb, seed)
    d = forward.fwd_acceleration(mm, forward.fwd_actuation(
        mm, forward.fwd_velocity(mm, forward.fwd_position(mm, d))))
    return d.replace(qacc_warmstart=0.9 * d.qacc_smooth)

  m64 = load(torch.float64)
  nb64 = 256
  args = solver.newton_args(m64, rows_state(m64, nb64, 75))
  out_k = newton_cuda.newton_kernel(*args, 1, 4)
  torch.cuda.synchronize()
  out_p = newton_cuda.newton_plain(*args, 1, 4)
  viol = newton_violation(out_k, out_p)
  off, worst_other, table = newton_rows_gate(args, out_k, out_p, 1, 4)
  unmatched = [row for row in table if row[1] == 0]
  print(f"newton f64 B{nb64} nefc{m.efc.nefc} nv{m.nv} it1 ls4 on the "
        f"hammock's rows: worst err / (1e-9 + 1e-9·|plain|) "
        + " ".join(f"{k} {v:.3f}" for k, v in viol.items())
        + f"; {len(off)} envs off elementwise (limit {nb64 // 100}), worst "
        f"err / limit on the others {worst_other:.3f}, replayed {table}",
        flush=True)
  if len(off) > nb64 // 100 or not worst_other <= 1.0 or unmatched:
    raise AssertionError("newton at nv 258: kernel and plain disagree")
  newton_f64 = dict(batch=nb64, violation=viol, off_envs=off, replay=table,
                    max_abs_err=(out_k[0] - out_p[0]).abs().max().item())
  del args, out_k, out_p, m64
  args = solver.newton_args(m, rows_state(m, nbatch, 76))
  out_k = newton_cuda.newton_kernel(*args, 1, 4)
  torch.cuda.synchronize()
  out_p = newton_cuda.newton_plain(*args, 1, 4)
  f32_gate = newton_f32_gate(f"newton f32 B{nbatch} nv{m.nv} it1 ls4 on "
                             f"the hammock's rows", args, out_k, out_p, 0.99)
  del out_k, out_p
  bound_ms, by, dense_ms, _, kept_mean, kept_max = newton_bound(args, 1, 4)
  occ = newton_cuda.occupancy(m.efc.nefc, m.nv, torch.float32)
  newton = dict(nv=m.nv, nefc=m.efc.nefc, bound_ms=bound_ms, bound_by=by,
                dense_bound_ms=dense_ms, kept_mean=kept_mean,
                kept_max=kept_max, **occ,
                ms=cuda_ms_cold(lambda: newton_cuda.newton_kernel(*args, 1, 4),
                                reps=10),
                plain_ms=cuda_ms_cold(
                    lambda: newton_cuda.newton_plain(*args, 1, 4), reps=2,
                    warmup=1),
                max_abs_err=newton_f64["max_abs_err"])
  print(f"newton f32 B{nbatch} nefc{m.efc.nefc} nv{m.nv} it1 ls4 on the "
        f"hammock's rows: kernel_ms {newton['ms']:.4f} (L2 flushed) plain_ms "
        f"{newton['plain_ms']:.4f} bound_ms {bound_ms:.5f} ({by}; kept rows "
        f"mean {kept_mean:.2f}, most {kept_max}; dense {dense_ms:.5f}); "
        f"{occ['threads']} threads per env, {occ['blocks_per_sm']} "
        f"blocks/SM", flush=True)
  del args
  torch.cuda.empty_cache()

  # the full width: 20 steps on the stage path, one LDL and one Newton
  # launch per step
  d0 = flex_batch(name, m, nbatch, 72)
  out, run = many_run(f"{name} (nv {m.nv}, {m.con.ncon} slots, "
                      f"{m.efc.nefc} rows)", m, d0, FLEX_NSTEP,
                      {"ldl_solve": 1.0, "newton_pyramidal": 1.0,
                       "megastep": 0.0})
  reset = int((out.time < FLEX_NSTEP * float(m.opt.timestep) * 0.999)
              .sum().item())
  # scan_steps hands back its input's contacts: the position stage's are
  # the final state's
  dd = forward.fwd_velocity(m, forward.fwd_position(m, out))
  live = dd.contact.dist < dd.contact.includemargin
  cloth = torch.as_tensor(m.con.flex2 >= 0, device="cuda")
  print(f"{name}: envs the guard reset {reset}; slots in contact per env "
        f"{live.float().sum(1).mean().item():.2f}, of them with the cloth "
        f"{(live & cloth).float().sum(1).mean().item():.2f}", flush=True)
  # the flex stages' device kernels in one step, counted apart
  flex_kernels = dict(
      flex_stage=kernel_count(lambda: flex.flex(m, dd)),
      flex_passive=kernel_count(lambda: (
          flex.edge_passive(m, dd),
          flex.elasticity_passive(m, dd, True, True))),
      collision_flex=kernel_count(lambda: collision_flex.flex_collision(
          m, dd, (dd.contact.dist.clone(), dd.contact.pos.clone(),
                  dd.contact.frame.clone(), dd.contact.flexvert.clone(),
                  dd.contact.flexvert1.clone(),
                  torch.zeros_like(dd.warning[:, 0])))))
  per_step = run["profile"]["kernel_launches_per_step"]
  print(f"{name}: device kernels per step {per_step:.1f}, of them the flex "
        f"stage {flex_kernels['flex_stage']}, flex passive "
        f"{flex_kernels['flex_passive']}, collision_flex "
        f"{flex_kernels['collision_flex']}", flush=True)
  del dd, out
  details["flex"] = dict(card_vs_cpu=check, ldl_n258=wide,
                         newton_nv258=newton, newton_nv258_f64_gate=newton_f64,
                         newton_nv258_f32_gate=f32_gate, hammock=run,
                         guard_resets=reset, flex_kernels=flex_kernels)
  report["ldl_solve"]["n258"] = wide
  report["newton_pyramidal"]["nv258"] = newton
  report["ldl_solve"].setdefault("launches_by_path", {})[
      "humanoid_hammock"] = run["launches"]["ldl_solve"]
  report["newton_pyramidal"].setdefault("launches_by_path", {})[
      "humanoid_hammock"] = run["launches"]["newton_pyramidal"]


RENDER_CHECK_B = 8
RENDER_CHECK_SIZE = 32
RENDER_COPIES = 64
RENDER_TOL = 1e-8          # card against CPU at f64, absolute plus relative
PIXEL_SIZE = 64
PIXEL_CONTROL = 10         # control steps of the pixel loop
PIXEL_NSTEP = 5            # physics steps per control step (0.025 s)
PIXEL_F64_B = 256
# a render scene whose casting light sees an occluder: shadows on
SHADOW_SCENES = ("render_lit", "render_lit_oblique")


def render_batch(mh, nbatch, seed):
  """make_batch of a CPU f64 Model at qpos0 plus 0.01·N(0, 1) from a
  numpy seed, forward-evaluated: the state both sides render."""
  from mujoco_tpu_torch.ops import forward
  from mujoco_tpu_torch.parallel import rollout
  d = rollout.make_batch(mh, nbatch, device="cpu")
  rng = np.random.default_rng(seed)
  q = d.qpos + torch.as_tensor(0.01 * rng.standard_normal(
      tuple(d.qpos.shape)))
  return forward.forward(mh, d.replace(qpos=q))


def render_along(m, d, orgs, dirs, **kw):
  """The port's render of a one-env Data along the rays (n, 3): its
  camera's rays replaced by these, an image of 1 × n pixels."""
  from mujoco_tpu_torch.ops import render
  saved = render._camera_origins_dirs
  render._camera_origins_dirs = lambda *a: (orgs[None], dirs[None])
  try:
    rgb, depth, seg = render.render(m, d, 0, orgs.shape[0], 1, **kw)
  finally:
    render._camera_origins_dirs = saved
  return rgb[0, 0], depth[0, 0], seg[0, 0]


def pixels_close(a, b, tol):
  a, b = a.cpu().double(), b.cpu().double()
  return ((a - b).abs() <= tol + tol * b.abs()) | (a == b)


def pixel_judge(card, cpu, mc, mh, dc, dh, camid, size, tol, **kw):
  """The pixels where the card misses the CPU (seg, depth where both hit,
  RGB): each passes only if RENDER_COPIES copies of its ray (origin and
  direction moved by at most 1e-13 relative), rerun on the CPU, give the
  card's result on one copy, or rerun on the card give the CPU's; at most
  1 % of pixels. Returns the pixels judged."""
  from mujoco_tpu_torch.ops import render
  (cr, cd, cs), (hr, hd, hs) = card, cpu
  cs, hs = cs.cpu(), hs.cpu()
  seg_ok = cs == hs
  hit = seg_ok & (hs >= 0)
  good = (seg_ok & pixels_close(cr, hr, tol).all(-1)
          & (~hit | pixels_close(cd, hd, tol)))
  bad = (~good).nonzero().tolist()
  if not bad:
    return 0
  if len(bad) > 0.01 * hs.numel():
    raise AssertionError(f"{len(bad)} pixels off, over 1 % of {hs.numel()}")
  orgs, dirs = render._camera_origins_dirs(mh, dh, camid, size, size,
                                           torch.float64)
  gen = torch.Generator().manual_seed(0)
  for b, y, x in bad:
    k = y * size + x
    move = 1 + 1e-13 * (2 * torch.rand((RENDER_COPIES, 3), generator=gen,
                                       dtype=torch.float64) - 1)
    move[0] = 1.0
    o, v = orgs[b, k] * move, dirs[b, k] * move

    def matches(m, d, dev, other):
      r, dd, sg = render_along(m.envs([b]), take_envs(d, [b]),
                               o.to(dev, m.dtype), v.to(dev, m.dtype), **kw)
      want_r, want_d, want_s = (t[b, y, x] for t in other)
      same = sg.cpu() == want_s.cpu()
      same &= pixels_close(r, want_r.expand_as(r), tol).all(-1)
      same &= (sg.cpu() < 0) | pixels_close(dd, want_d.expand_as(dd), tol)
      return bool(same.any())

    if not (matches(mh, dh, "cpu", card) or matches(mc, dc, "cuda", cpu)):
      raise AssertionError(f"pixel (env {b}, row {y}, col {x}): card seg "
                           f"{int(cs[b, y, x])}, CPU {int(hs[b, y, x])}, "
                           f"not a last-bit case")
  return len(bad)


def render_card_vs_cpu(name):
  """A zoo.RENDER scene at f64, B RENDER_CHECK_B, 32×32, from the same
  state: render (shadows on for SHADOW_SCENES) card against CPU by
  pixel_judge; skin_update and update_scene within 1e-10. Returns
  (pixels judged, pixels hit)."""
  from mujoco_tpu_torch import vis
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import render, skin
  mh = zoo.load(name, torch.float64, "cpu")
  mc = zoo.load(name, torch.float64, "cuda")
  dh = render_batch(mh, RENDER_CHECK_B, 81)
  dc = dh.to("cuda")
  kw = dict(shadows=name in SHADOW_SCENES)
  n = RENDER_CHECK_SIZE
  cpu = render.render(mh, dh, 0, n, n, **kw)
  card = render.render(mc, dc, 0, n, n, **kw)
  judged = pixel_judge(card, cpu, mc, mh, dc, dh, 0, n, RENDER_TOL, **kw)
  pairs = [(vis.update_scene(mc, dc, contact_forces=True),
            vis.update_scene(mh, dh, contact_forces=True))]
  if mh.nskin:
    pairs.append((skin.skin_update(mc, dc), skin.skin_update(mh, dh)))
  for a, b in pairs:
    fields = ([getattr(a, f) for f in ("pos", "mat", "size", "rgba")],
              [getattr(b, f) for f in ("pos", "mat", "size", "rgba")]) \
        if isinstance(a, vis.Scene) else (a, b)
    for x, y in zip(*fields):
      err = (x.cpu() - y).abs().max().item() if x.numel() else 0.0
      if not err <= 1e-10:
        raise AssertionError(f"{name}: card against CPU {err:.3e} > 1e-10")
  return judged, int((cpu[2] >= 0).sum())


def rebuild_frames(m, d):
  """The frames the render reads, from the state scan_steps returns (it
  carries only STATE_FIELDS), in fwd_position's order."""
  from mujoco_tpu_torch.ops import smooth
  return smooth.camlight(m, smooth.com_pos(m, smooth.kinematics(m, d)))


def pixel_controls(m, nbatch, seed):
  """One control per control step and env, uniform in ctrlrange."""
  rng = np.random.default_rng(seed)
  lo, hi = m.actuator_ctrlrange.cpu().double().numpy().T
  return [rng.uniform(lo, hi, (nbatch, m.nu)) for _ in range(PIXEL_CONTROL)]


def pixel_loop(m, d, controls, camid, gate, advance=None):
  """The pixel-RL loop: per control step, ctrl set, PIXEL_NSTEP steps of
  scan_steps(check=True) (or of ``advance(d)``), the frames rebuilt, a
  frame of every env. gate(m, frame) checks each frame and returns the
  share of envs that see the humanoid; returns (the least such share,
  device ms of the steps and of the frames, host wall s)."""
  from mujoco_tpu_torch.models import io
  from mujoco_tpu_torch.ops import render
  from mujoco_tpu_torch.parallel import rollout
  if advance is None:
    fresh = io.make_data(m)
    advance = lambda dd: rollout.scan_steps(m, dd, PIXEL_NSTEP, fresh,
                                            check=True)
  events, seen = [], 1.0
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for ctrl in controls:
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    d = d.replace(ctrl=torch.as_tensor(ctrl, dtype=m.dtype, device="cuda"))
    ev[0].record()
    d = advance(d)
    ev[1].record()
    frame = render.render(m, rebuild_frames(m, d), camid, PIXEL_SIZE,
                          PIXEL_SIZE)
    ev[2].record()
    events.append(ev)
    seen = min(seen, gate(m, frame))
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  step_ms = sum(e[0].elapsed_time(e[1]) for e in events)
  frame_ms = sum(e[1].elapsed_time(e[2]) for e in events)
  return seen, step_ms, frame_ms, wall


def pixel_gate(m, frame):
  """Finite frames, RGB in [0, 1], depth > 0 where seg ≥ 0, the humanoid
  (geoms 1..ngeom−1) in the frame of at least 99 % of envs; returns
  that share."""
  rgb, depth, seg = frame
  hit = seg >= 0
  if not (torch.isfinite(rgb).all() and torch.isfinite(depth[hit]).all()):
    raise AssertionError("pixel loop: a frame is not finite")
  if not (rgb.min() >= 0 and rgb.max() <= 1 and (depth[hit] > 0).all()):
    raise AssertionError("pixel loop: RGB outside [0, 1] or depth ≤ 0")
  seen = ((seg >= 1) & (seg < m.ngeom)).flatten(1).any(1).float().mean()
  if seen < 0.99:
    raise AssertionError(f"pixel loop: the humanoid in {seen:.2%} of envs")
  return float(seen)


def seg_edge(seg):
  """(B, H, W) bool: pixels with a 4-neighbour of another seg id."""
  pad = torch.nn.functional.pad(seg[:, None].float(), (1, 1, 1, 1),
                                mode="replicate")[:, 0]
  c = pad[:, 1:-1, 1:-1]
  return ((pad[:, :-2, 1:-1] != c) | (pad[:, 2:, 1:-1] != c)
          | (pad[:, 1:-1, :-2] != c) | (pad[:, 1:-1, 2:] != c))


PRECISION_MOVE = 1e-6     # relative moves of the f32 rule's ray copies


def precision_judge(frames, states, b, y, x, camid):
  """Whether pixel (b, y, x), which misses between the f32 and the f64
  frame of one state, is decided by f32 rounding: RENDER_COPIES copies of
  its ray (origin and direction moved by at most PRECISION_MOVE
  relative, about eight f32 ulps), cast at f32, give the f64 pixel (seg
  equal, depth within 1e-4 relative) on one copy, or cast at f64 give
  the f32 pixel."""
  from mujoco_tpu_torch.ops import render
  (m32, f32), (m64, f64) = states
  orgs, dirs = render._camera_origins_dirs(m64, take_envs(f64, [b]), camid,
                                           PIXEL_SIZE, PIXEL_SIZE,
                                           torch.float64)
  k = y * PIXEL_SIZE + x
  gen = torch.Generator(device="cuda").manual_seed(k)
  move = 1 + PRECISION_MOVE * (2 * torch.rand(
      (RENDER_COPIES, 3), generator=gen, device="cuda",
      dtype=torch.float64) - 1)
  move[0] = 1.0
  o, v = orgs[0, k] * move, dirs[0, k] * move
  for (m, fr), (_, depth, seg) in (((m32, f32), frames[1]),
                                   ((m64, f64), frames[0])):
    _, dd, sg = render_along(m, take_envs(fr, [b]), o.to(m.dtype),
                             v.to(m.dtype))
    want_d, want_s = depth[b, y, x].double(), seg[b, y, x]
    ok = (sg == want_s) & ((sg < 0) | ((dd.double() - want_d).abs()
                                       <= 1e-4 * want_d.abs()))
    if bool(ok.any()):
      return True
  return False


def precision_loop(name, nbatch, controls, camid):
  """The pixel loop at f64 (the stage path), each control step's state
  framed at f64 and, cast to f32, rebuilt and rendered at f32: seg equal
  on ≥ 99 % of pixels, depth within 1e-4 relative where seg agrees, and
  every pixel that misses on a seg edge of one of the two images or
  decided by f32 rounding (``precision_judge``, at most 1e-4 of the
  pixels). As a witness, not a gate, each control step also runs at f32
  through the megastep from the f64 state before it. Returns the worst
  share of equal seg, the pixels off, those judged, and the most envs
  the f32 step leaves off by the megastep's f32 rule (qpos within 2e-4
  of the env's largest |value|)."""
  from mujoco_tpu_torch.models import io, zoo
  from mujoco_tpu_torch.ops import render
  from mujoco_tpu_torch.parallel import rollout
  m64, m32 = zoo.load(name, torch.float64), zoo.load(name, torch.float32)
  fresh64, fresh32 = io.make_data(m64), io.make_data(m32)
  d = start_batch(m64, nbatch, 93)
  worst, nbad, judged, drifted = 1.0, 0, 0, 0
  for step, ctrl in enumerate(controls):
    d = d.replace(ctrl=torch.as_tensor(ctrl, dtype=torch.float64,
                                       device="cuda"))
    step32 = rollout.scan_steps(m32, d.to(dtype=torch.float32), PIXEL_NSTEP,
                                fresh32, check=True)
    d = rollout.scan_steps(m64, d, PIXEL_NSTEP, fresh64, check=True)
    gap = ((step32.qpos.double() - d.qpos).abs().amax(1)
           / torch.clamp(d.qpos.abs().amax(1), min=1.0))
    drifted = max(drifted, int((gap >= 2e-4).sum()))
    states = [(m, rebuild_frames(m, d.to(dtype=m.dtype))) for m in (m32, m64)]
    frames = [render.render(m, f, camid, PIXEL_SIZE, PIXEL_SIZE)
              for m, f in states]
    (_, d32, s32), (_, d64, s64) = frames
    same = s32 == s64
    share = same.float().mean().item()
    hit = same & (s64 >= 0)
    off = ~same | (hit & ((d32.double() - d64).abs() > 1e-4 * d64.abs()))
    inside = (off & ~(seg_edge(s32) | seg_edge(s64))).nonzero().tolist()
    if len(inside) > 1e-4 * s64.numel():
      raise AssertionError(f"f32 against f64, control step {step}: "
                           f"{len(inside)} off pixels inside a region")
    for b, y, x in inside:
      if not precision_judge(frames, states, b, y, x, camid):
        raise AssertionError(
            f"f32 against f64, control step {step}: pixel (env {b}, row "
            f"{y}, col {x}) inside a region: seg {int(s32[b, y, x])} and "
            f"{int(s64[b, y, x])}, depth {float(d32[b, y, x])} and "
            f"{float(d64[b, y, x])}, not decided by f32 rounding")
    if share < 0.99:
      raise AssertionError(f"f32 against f64, control step {step}: seg "
                           f"equal on {share:.4%}")
    worst, nbad, judged = (min(worst, share), nbad + int(off.sum()),
                           judged + len(inside))
  return worst, nbad, judged, drifted


def phase_pixels(report, details):
  """28: ray and render. Every zoo.RENDER scene with a camera card
  against CPU at f64; the pixel loop of humanoid_pixels at f32, B 3072,
  64×64, 10 control steps of 5 physics steps (one megastep launch each);
  the same loop f32 against f64 at B 256; frame, loop and skin timings."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import megastep_cuda, ray, render, skin
  from mujoco_tpu_torch.parallel import rollout

  # card = CPU at f64 on the render, skin, vis and USD scenes
  check = {}
  for name in zoo.RENDER:
    if not zoo.load(name, torch.float64, "cpu").ncam:
      continue
    judged, hits = render_card_vs_cpu(name)
    check[name] = dict(judged=judged, hits=hits)
    print(f"{name} card vs CPU f64 B{RENDER_CHECK_B} {RENDER_CHECK_SIZE}²"
          f"{' shadows' if name in SHADOW_SCENES else ''}: depth and RGB "
          f"within {RENDER_TOL:g} where seg agrees, {hits} pixels hit, "
          f"{judged} judged by last-bit copies; update_scene"
          f"{' and skin_update' if name.startswith('skin') else ''} within "
          f"1e-10", flush=True)

  name = "humanoid_pixels"
  m = zoo.load(name, torch.float32)
  if not megastep_cuda.supported(m):
    raise AssertionError("the megastep refuses humanoid_pixels")
  side = m.names["camera"]["side"]
  npix = PIXEL_SIZE * PIXEL_SIZE
  nbatch = B
  while render.env_chunk(m, rollout.make_batch(m, nbatch), npix) < nbatch:
    nbatch //= 2
  estimate = nbatch * render.frame_bytes_per_env(m, npix, m.dtype)
  print(f"pixel loop batch {nbatch} (a frame's peak estimated at "
        f"{estimate / 2**30:.2f} GiB)", flush=True)
  controls = pixel_controls(m, nbatch, 90)
  d0 = start_batch(m, nbatch, 91)
  # warm: one control step, not counted
  pixel_loop(m, d0, controls[:1], side, pixel_gate)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  reset_counts()
  seen, step_ms, frame_ms, wall = pixel_loop(m, d0, controls, side,
                                             pixel_gate)
  launches = read_counts()
  peak = torch.cuda.max_memory_allocated()
  if launches != {"ldl_solve": 0, "newton_pyramidal": 0,
                  "megastep": PIXEL_CONTROL}:
    raise AssertionError(f"pixel loop launches {launches}: want one megastep "
                         f"launch per control step and no other")
  rate = nbatch * PIXEL_CONTROL / wall
  print(f"pixel loop {name} f32 B{nbatch} {PIXEL_SIZE}² {PIXEL_CONTROL} "
        f"control steps of {PIXEL_NSTEP}: launches {launches}, "
        f"{rate:.1f} env-frames/s (wall {wall:.3f} s), device: megastep "
        f"{step_ms:.3f} ms, frames {frame_ms:.3f} ms (share "
        f"{frame_ms / (step_ms + frame_ms):.2%}), peak memory "
        f"{peak / 2**30:.2f} GiB, the humanoid in at least {seen:.2%} of "
        f"envs", flush=True)

  # one frame of the whole batch: ms, kernels, idle share
  f = rebuild_frames(m, rollout.scan_steps(m, d0, PIXEL_NSTEP, check=True))
  frame = lambda sh=False: render.render(m, f, side, PIXEL_SIZE, PIXEL_SIZE,
                                         shadows=sh)
  ms = cuda_ms(frame, reps=3, warmup=1)
  ms_shadows = cuda_ms(lambda: frame(True), reps=3, warmup=1)
  kernels = kernel_count(frame, attempts=2)
  orgs, dirs = render._camera_origins_dirs(m, f, side, PIXEL_SIZE,
                                           PIXEL_SIZE, m.dtype)
  ray_kernels = kernel_count(lambda: ray.ray(m, f, orgs, dirs), attempts=2)
  del orgs, dirs
  prof = profile_window(lambda: (frame(), torch.cuda.synchronize()), 1)[0]
  step5_ms = cuda_ms(lambda: rollout.scan_steps(m, d0, PIXEL_NSTEP,
                                                check=True), reps=5)
  # the least a frame could take: its RGB, depth and seg written once
  written = nbatch * npix * (4 * m.qpos0.element_size() + 4)
  frame_bound_ms = written / PEAK_BYTES_PER_S * 1e3
  print(f"frame {name} B{nbatch} {PIXEL_SIZE}²: {ms:.3f} ms, shadows "
        f"{ms_shadows:.3f} ms, {kernels} device kernels ({ray_kernels} of "
        f"them the camera rays' ray.ray), idle "
        f"{prof['device_idle_share']:.2%} of a profiled frame "
        f"({prof['device_busy_ms_per_step']:.3f} busy of "
        f"{prof['wall_ms_per_step']:.3f} ms); bound by the bytes a frame "
        f"writes {frame_bound_ms:.4f} ms ({written / 2**20:.1f} MiB); a "
        f"megastep launch of {PIXEL_NSTEP} steps {step5_ms:.3f} ms",
        flush=True)
  print_profile(f"frame {name}", prof)
  del f, d0

  # f32 against f64 on the card, B 256: the frames of the f64 loop's
  # states at both precisions
  share, nbad, judged, drifted = precision_loop(
      name, PIXEL_F64_B, pixel_controls(m, PIXEL_F64_B, 92), side)
  print(f"pixel loop f64 B{PIXEL_F64_B}, its states' frames at f32 against "
        f"f64: seg equal on at least {share:.4%} of pixels, {nbad} pixels "
        f"off, on a seg edge but {judged} decided by f32 rounding "
        f"(copies of the ray); witness, not a gate: the same control steps "
        f"at f32 through the megastep leave at most {drifted} envs off by "
        f"the megastep's f32 rule (qpos within 2e-4)", flush=True)

  # skin_update at the full batch
  mm = zoo.load("skin", torch.float32)
  ds = rebuild_frames(mm, rollout.make_batch(mm, B))
  ms_skin = cuda_ms(lambda: skin.skin_update(mm, ds), reps=20)
  print(f"skin_update skin f32 B{B}: {ms_skin:.4f} ms", flush=True)

  details["pixels"] = dict(
      card_vs_cpu=check, batch=nbatch, launches=launches,
      env_frames_per_s=rate, wall_s=wall, megastep_device_ms=step_ms,
      frames_device_ms=frame_ms, peak_gib=peak / 2**30,
      frame_ms=ms, frame_shadows_ms=ms_shadows, frame_kernels=kernels,
      ray_kernels=ray_kernels, frame_bound_ms=frame_bound_ms,
      frame_profile=prof, megastep_5_steps_ms=step5_ms,
      peak_estimate_gib=estimate / 2**30, humanoid_seen=seen,
      f32_f64_drifted_envs=drifted, f32_f64_seg_share=share,
      f32_f64_off_pixels=nbad, f32_f64_judged_pixels=judged,
      skin_update_ms=ms_skin)
  report["megastep"].setdefault("launches_by_path", {})[name] = \
      launches["megastep"]


WIDE_NSTEP = 20            # steps of phase 29's rollouts and timings
WIDE_CHECK_B = 256         # phase 29's f64 batch
WIDE_COPIES = 64           # last-bit copies of an env that misses at f64
WIDE_SCENES = ("multi_humanoid3", "multi_humanoid10")


def wide_model(name, dtype, device="cuda"):
  """A scene of phase 29: multi_humanoid3 as it is (nv 81, below the
  island gate), multi_humanoid10 with islands disabled (nv 270), as a
  multi-tree model opts into the megastep (megastep_tpu.py:114-120)."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.models.types import DisableBit
  m = zoo.load(name, dtype, device)
  if name == "multi_humanoid10":
    m = zoo.load(name, dtype, device, opt={"disableflags": int(
        m.opt.disableflags) | int(DisableBit.ISLAND)})
  return m


def megastep_copies(state, idx, ncopy):
  """ncopy copies of each env idx of a megastep state, qpos, qvel and the
  warmstart moved at the last bit (``last_bits``), from a fixed seed, so
  that the kernel and the plain version see the same copies."""
  gen = torch.Generator().manual_seed(0)
  out = {}
  for k, v in state.items():
    rep = v[idx].repeat_interleave(ncopy, 0)
    if k in ("qpos", "qvel", "warm"):
      rep = rep * (1 + last_bits(rep.shape, gen).to(rep.device, rep.dtype))
    out[k] = rep.contiguous()
  return out


def megastep_gate_f64(tag, m, state, fresh, nstep):
  """The kernel against its plain version at f64 under phase 11's rule:
  every env elementwise, 1e-9 + 1e-9·|plain| on qpos and qvel, but at
  most 1 %, each of which passes only if the plain version or the kernel,
  rerun on WIDE_COPIES last-bit copies of that env's state, accounts for
  the other side's result (``judge_envs``). Returns (worst violation,
  envs judged, max abs qpos error)."""
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  out_k = mc.megastep_kernel(m, state, nstep, fresh)
  torch.cuda.synchronize()
  out_p = mc.megastep_plain(m, state, nstep, fresh)
  keys = ("qpos", "qvel")
  worst = max(((out_k[k] - out_p[k]).abs() / (1e-9 + 1e-9 * out_p[k].abs()))
              .max().item() for k in keys)

  def rerun(fn):
    def run(idx):
      idx = idx.to(state["qpos"].device)
      out = fn(m, megastep_copies(state, idx, WIDE_COPIES), nstep, fresh)
      return [out[k].reshape(len(idx), WIDE_COPIES, -1) for k in keys]
    return run

  judged = judge_envs([out_k[k][None] for k in keys],
                      [out_p[k][None] for k in keys],
                      rerun(mc.megastep_plain), rerun(mc.megastep_kernel),
                      None, 1e-9, 0.01)
  err = (out_k["qpos"] - out_p["qpos"]).abs().max().item()
  print(f"wide megastep f64 {tag} B{state['qpos'].shape[0]} {nstep} steps "
        f"({mc.route(m, m.dtype)} route): worst err / (1e-9 + 1e-9·|plain|) "
        f"{worst:.3e}, {judged} envs off elementwise and explained by "
        f"last-bit copies, max abs qpos err {err:.3e}", flush=True)
  return worst, judged, err


def megastep_card_vs_cpu(name, nbatch=8, nstep=5):
  """The wide megastep kernel on the card against megastep_plain on the
  CPU at f64, from the same numpy-seeded state: qpos and qvel within
  1e-8 + 1e-8·|CPU|."""
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  outs = {}
  for dev in ("cuda", "cpu"):
    m = wide_model(name, torch.float64, dev)
    state, fresh = posed_state(m, nbatch, 11)
    state = {k: v.to(dev) for k, v in state.items()}
    fresh = {k: v.to(dev) for k, v in fresh.items()}
    outs[dev] = mc.run(m, state, nstep, fresh)
  worst = max(((outs["cuda"][k].cpu() - outs["cpu"][k]).abs()
               / (1e-8 + 1e-8 * outs["cpu"][k].abs())).max().item()
              for k in ("qpos", "qvel"))
  print(f"wide megastep {name}: {nstep} steps f64 B{nbatch}, the card's "
        f"kernel against the CPU's plain version, worst err / (1e-8 + "
        f"1e-8·|CPU|) {worst:.3f}", flush=True)
  if not worst <= 1.0:
    raise AssertionError(f"wide megastep {name}: card and CPU differ")
  return worst


def wide_f64_times(m64, clock) -> dict:
  """The kernel at f64 on the full batch (B 3072, WIDE_NSTEP steps, L2
  flushed) beside its f64 bound over the f32 run's active rows (clock)
  and the plain version's time per step, printed."""
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  state, fresh = posed_state(m64, B, 3, lower=0.15)
  ms = cuda_ms_cold(lambda: mc.megastep_kernel(m64, state, WIDE_NSTEP,
                                               fresh), reps=2, warmup=1)
  active = (clock["mean_active_rows"], clock["mean_active_slots"])
  bound_ms, bound_by = bound(megastep_bytes(m64, B), B * WIDE_NSTEP
                             * megastep_flops(m64, active), torch.float64)
  t = time.perf_counter()
  mc.megastep_plain(m64, state, 1, fresh)
  torch.cuda.synchronize()
  plain_ms = (time.perf_counter() - t) * 1e3
  print(f"wide megastep f64 B{B} {WIDE_NSTEP} steps "
        f"({mc.route(m64, torch.float64)} route): kernel_ms {ms:.3f} (L2 "
        f"flushed) plain_ms {plain_ms:.3f} per step, bound_ms "
        f"{bound_ms:.4f} ({bound_by})", flush=True)
  return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by)


def layout_counts(models) -> dict:
  """The host's shared-memory count (``smem_bytes``, which picks the route)
  against the CUDA source's (``smem_bytes_kernel``, which the launch
  asks for) for each model on both routes at both dtypes, beside the wide
  route's device values per env (``work_values_kernel``, which the launch
  allocates), printed; raises where the two shared counts differ."""
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  out = {}
  for name, m in models.items():
    for dtype in (torch.float32, torch.float64):
      for r in mc.ROUTES:
        host, card = mc.smem_bytes(m, dtype, r), mc.smem_bytes_kernel(
            m, dtype, r)
        out[f"{name} {str(dtype)[6:]} {r}"] = dict(
            host=host, card=card, work_values=(
                mc.work_values_kernel(m, dtype) if r == "wide_device"
                else 0))
        if host != card:
          raise AssertionError(f"megastep shared memory {name} {dtype} {r}: "
                               f"host {host} B, card {card} B")
  print(f"megastep layout: host = card on the shared bytes of {len(out)} "
        f"(model, dtype, route)", flush=True)
  return out


def phase_wide_megastep(report, details):
  """29: the megastep's wide route (nv > 64) at full width on
  multi_humanoid3 and the ten-humanoid scene without islands."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  out_details, wide = {}, {}
  for name in WIDE_SCENES:
    m = wide_model(name, torch.float32)
    route = mc.route(m, torch.float32)
    if not mc.supported(m) or route == "narrow":
      raise AssertionError(f"{name}: supported {mc.supported(m)}, route "
                           f"{route}")
    # the main path: scan_steps, one megastep launch, no LDL or Newton
    d = main_path_batch(m)
    torch.cuda.reset_peak_memory_stats()
    out, wall, launches = stage_run(m, d, WIDE_NSTEP)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(out.qpos).all()
                  & torch.isfinite(out.qvel).all())
    if not finite or launches != {"ldl_solve": 0, "newton_pyramidal": 0,
                                  "megastep": 1}:
      raise AssertionError(f"{name} scan_steps: finite {finite}, launches "
                           f"{launches}")
    _, wall2, _ = stage_run(m, d, WIDE_NSTEP)
    with stage_path():
      stage_run(m, d, 1)
      _, swall, slaunch = stage_run(m, d, 3)
    sps, sps2, stage_sps = (B * WIDE_NSTEP / wall, B * WIDE_NSTEP / wall2,
                            B * 3 / swall)
    print(f"wide megastep {name} (nv {m.nv}, nefc {m.efc.nefc}, {route} "
          f"route) f32 B{B} {WIDE_NSTEP} steps of scan_steps: wall "
          f"{wall:.4f} s, {sps:.1f} env-steps/s (second call {sps2:.1f}), "
          f"launches {launches}, finite {finite}, peak memory "
          f"{peak / 2**30:.2f} GiB; the stage path (MJTPU_MEGASTEP=0) "
          f"{stage_sps:.1f} env-steps/s ({slaunch}, 3 steps); megastep / "
          f"stage {sps2 / stage_sps:.2f}x", flush=True)
    report["megastep"].setdefault("launches_by_path", {})[
        name if name == "multi_humanoid3" else name + "_monolithic"] = \
        launches["megastep"]

    # the kernel's time at the full width, its bound and where it goes
    state, fresh = posed_state(m, B, 3, lower=0.15)
    ms = cuda_ms_cold(lambda: mc.megastep_kernel(m, state, WIDE_NSTEP,
                                                 fresh), reps=3, warmup=1)
    clock = stage_clock(m, state, fresh, f"{name} timing inputs",
                        nstep=WIDE_NSTEP)
    active = (clock["mean_active_rows"], clock["mean_active_slots"])
    bound_ms, bound_by = bound(megastep_bytes(m, B), B * WIDE_NSTEP
                               * megastep_flops(m, active), torch.float32)
    occ = occupancy(m)
    # the kernel against its plain version at f32, full width, one step
    # (phase 4's f32 rule), the plain version timed on the same call
    out_k = mc.megastep_kernel(m, state, 1, fresh)
    t = time.perf_counter()
    out_p = mc.megastep_plain(m, state, 1, fresh)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    gate32 = check_f32(f"{name} B{B} 1 step", out_k, out_p)
    del out_k, out_p
    print(f"wide megastep {name} f32 B{B} {WIDE_NSTEP} steps: kernel_ms "
          f"{ms:.3f} (L2 flushed; {ms / WIDE_NSTEP:.4f} per step) plain_ms "
          f"{plain_ms:.3f} per step, bound_ms {bound_ms:.4f} ({bound_by}; "
          f"{megastep_flops(m, active):.0f} operations per env-step over "
          f"{active[0]:.2f} active rows and {active[1]:.2f} active slots); "
          f"kernel / bound {ms / bound_ms:.1f}", flush=True)
    del state, out
    torch.cuda.empty_cache()

    # f64 at B 256 under phase 11's rule, on the card against the CPU
    m64 = wide_model(name, torch.float64)
    s64, f64 = posed_state(m64, WIDE_CHECK_B, 7)
    worst, judged, err = megastep_gate_f64(name, m64, s64, f64, 3)
    cpu_worst = f64_times = None
    if name == "multi_humanoid3":
      cpu_worst = megastep_card_vs_cpu(name)
      f64_times = wide_f64_times(m64, clock)
    wide[name] = dict(route=route, nv=m.nv, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by,
                      launches=launches["megastep"], max_abs_err=err,
                      env_steps_per_s=sps2, stage_env_steps_per_s=stage_sps,
                      f64_route=mc.route(m64, torch.float64),
                      f64=f64_times)
    out_details[name] = dict(
        wide[name], first_call_env_steps_per_s=sps, peak_memory_bytes=peak,
        stage_launches=slaunch, stage_clock=clock, occupancy=occ,
        occupancy_f64=occupancy(m64), f32_gate=gate32, f64_worst=worst,
        f64_judged=judged, card_vs_cpu_worst=cpu_worst,
        flops_per_env_step=megastep_flops(m, active))
    del m64, s64
    torch.cuda.empty_cache()

  # the humanoid set on the wide route (one tile), under the same rule
  m64 = zoo.humanoid(torch.float64)
  mc._entry(m64).setdefault("route", {})[torch.float64] = "wide_device"
  s64, f64 = posed_state(m64, WIDE_CHECK_B, 8)
  out_details["humanoid_wide_device_f64"] = megastep_gate_f64(
      "humanoid set on the wide route", m64, s64, f64, 3)
  out_details["layout_counts"] = layout_counts(dict(
      {n: wide_model(n, torch.float32) for n in WIDE_SCENES},
      **{n: zoo.load(n, torch.float32) for n in MEGASTEP_MODELS}))
  details["wide_megastep"] = out_details
  report["megastep"]["wide"] = wide


SDF_NSTEP = 20             # phase 30's full-width rollout
SDF_CHECK_B = 64           # phase 30's f64 card-against-CPU batch
SDF_CHECK_NSTEP = 10
SDF_NEWTON_B64 = 256
# last-bit moves of a judged env's copies, the larger ones where the
# smaller leave the deciding bits of a box's corner start alone
# (tests/test_torch_sdf_scenes.py)
SDF_MOVES = (1e-15, 1e-14, 1e-13, 1e-12)
SDF_COPIES = 16
CALLBACK_NSTEP = 20


def sdf_batch(name, m, nbatch, seed, device="cuda"):
  """make_batch of a zoo.SDF scene at its start in contact
  (zoo.SDF_START) from a numpy seed: the free body's position moved by
  0.003·N(0, 1), qvel 0.05·N(0, 1), ctrl uniform in [-2, 2] per env; the
  same on the card and the CPU."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.parallel import rollout
  d = rollout.make_batch(m, nbatch, device=device)
  rng = np.random.default_rng(seed)
  qpos = d.qpos.cpu().double().numpy().copy()
  for k, v in zoo.SDF_START[name].items():
    qpos[:, k] = v
  qpos[:, :3] += 0.003 * rng.standard_normal((nbatch, 3))
  qvel = 0.05 * rng.standard_normal((nbatch, m.nv))
  ctrl = rng.uniform(-2.0, 2.0, (nbatch, m.nu))
  as_t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=device)
  return d.replace(qpos=as_t(qpos), qvel=as_t(qvel), ctrl=as_t(ctrl))


def sdf_card_vs_cpu(name, nstep=SDF_CHECK_NSTEP):
  """nstep steps at f64, B SDF_CHECK_B, each step of the CPU's state on
  the card and on the CPU: qpos, qvel and every slot's dist within 1e-8
  absolute plus relative, an env that misses judged by last-bit copies of
  its state on both sides (judge_envs), the moves of SDF_MOVES tried in
  turn. Returns (env-steps judged, the largest move used, SDF slots in
  contact over the run)."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward
  mc = zoo.load(name, torch.float64, "cuda")
  mh = zoo.load(name, torch.float64, "cpu")
  d = sdf_batch(name, mh, SDF_CHECK_B, 81, "cpu")
  judged, largest, live = 0, 0.0, 0
  for _ in range(nstep):
    out_h = forward.step(mh, d)
    out_c = forward.step(mc, d.to("cuda"))
    live += int((out_h.contact.dist < out_h.contact.includemargin).sum())
    card = [out_c.qpos[None], out_c.qvel[None], out_c.contact.dist[None]]
    cpu = [out_h.qpos[None], out_h.qvel[None], out_h.contact.dist[None]]

    def rerun(idx, m, scale, d=d):
      k = SDF_COPIES
      gen = torch.Generator().manual_seed(0)
      copies = take_envs(d, idx.repeat_interleave(k))
      moved = {f: getattr(copies, f) * (1 + scale / 1e-15 * last_bits(
          getattr(copies, f).shape, gen)) for f in ("qpos", "qvel")}
      r = forward.step(m, copies.replace(**moved).to(m.device))
      return [x.reshape((len(idx), k) + x.shape[1:])
              for x in (r.qpos, r.qvel, r.contact.dist)]

    for scale in SDF_MOVES:
      try:
        judged += judge_envs(card, cpu, lambda idx: rerun(idx, mh, scale),
                             lambda idx: rerun(idx, mc, scale), SDF_COPIES,
                             1e-8, 1.0)
        largest = max(largest, scale)
        break
      except AssertionError:
        if scale == SDF_MOVES[-1]:
          raise
    d = out_h
  return judged, largest, live


def callback_model(dtype, device="cuda"):
  """``sensor_suite`` (two hinges, a motor, 29 sensors) with tests/
  test_plugin.py's callbacks as torch functions on the batched Data: the
  motor's gain and bias USER (gain 3, bias −0.5·velocity), its first
  sensor (a jointpos) a USER sensor reading the lower body's height, and
  a passive spring −4·(qpos − 0.3); built from the snapshot's fields with
  the callbacks registered, then the registry cleared."""
  from mujoco_tpu_torch import plugin
  from mujoco_tpu_torch.models import io, zoo
  from mujoco_tpu_torch.models.types import BiasType, GainType, SensorType
  fields = zoo.load_snapshot("sensor_suite")
  for key, value in (("actuator_gaintype", GainType.USER),
                     ("actuator_biastype", BiasType.USER),
                     ("sensor_type", SensorType.USER)):
    fields[key] = fields[key].copy()
    fields[key][0] = int(value)
  plugin.set_actuator_callbacks(
      gain=lambda m, d, i: torch.tensor(3.0, dtype=d.qpos.dtype),
      bias=lambda m, d, i: -0.5 * d.actuator_velocity[:, i])
  plugin.set_sensor_callback(lambda m, d, i: d.xpos[:, 2, 2][:, None])
  plugin.set_passive_callback(lambda m, d: -4.0 * (d.qpos - 0.3))
  try:
    return io.model_from_numpy(fields, dtype, device)
  finally:
    plugin.set_actuator_callbacks()
    plugin.set_sensor_callback(None)
    plugin.set_passive_callback(None)


def callback_check():
  """The callback scene, B SDF_CHECK_B at f64 from a numpy seed (qpos
  0.3·N(0, 1), ctrl N(0, 1)), CALLBACK_NSTEP steps, each of the CPU's
  state on the card and the CPU: qpos, qvel and sensordata within 1e-8
  absolute plus relative, every state finite, the USER sensor equal to
  the height it reads. Returns the largest |card − CPU|."""
  from mujoco_tpu_torch.ops import forward, megastep_cuda
  from mujoco_tpu_torch.parallel import rollout
  mc, mh = callback_model(torch.float64), callback_model(
      torch.float64, "cpu")
  if megastep_cuda.supported(callback_model(torch.float32)):
    raise AssertionError("the megastep admits the callback scene")
  rng = np.random.default_rng(91)
  d = rollout.make_batch(mh, SDF_CHECK_B, device="cpu")
  d = d.replace(qpos=d.qpos + torch.as_tensor(
      0.3 * rng.standard_normal(tuple(d.qpos.shape))),
      ctrl=torch.as_tensor(rng.standard_normal(tuple(d.ctrl.shape))))
  worst = 0.0
  for _ in range(CALLBACK_NSTEP):
    out_h = forward.step(mh, d)
    out_c = forward.step(mc, d.to("cuda"))
    for f in ("qpos", "qvel", "sensordata"):
      a, b = getattr(out_c, f).cpu(), getattr(out_h, f)
      if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"callback scene: {f} not finite on the card")
      err = ((a - b).abs() / (1 + b.abs())).max().item()
      worst = max(worst, err)
      if err > 1e-8:
        raise AssertionError(f"callback scene: card and CPU differ in {f} "
                             f"by {err:.3e}")
    # a sensor's value is the forward pass's: the USER sensor reads the
    # height of the state before the step
    height = forward.fwd_position(mh, d).xpos[:, 2, 2]
    if not torch.equal(out_h.sensordata[:, 0], height):
      raise AssertionError("callback scene: the USER sensor is not the "
                           "height it reads")
    d = out_h
  return worst


def sdf_pass(m, d):
  """The SDF collision pass of one step at d (positions from
  fwd_position): (device ms, kernels, wall ms) from one profiled warm
  call."""
  from mujoco_tpu_torch.ops import collision_sdf, forward
  dd = forward.fwd_position(m, d)

  def once():
    c = dd.contact
    collision_sdf.sdf_collision(m, dd, c.dist.clone(), c.pos.clone(),
                                c.frame.clone())
    torch.cuda.synchronize()

  once()
  prof = profile_window(once, 1)[0]
  return (prof["device_busy_ms_per_step"], prof["kernel_launches_per_step"],
          prof["wall_ms_per_step"])


def phase_sdf(report, details):
  """30: SDF collision and the plugin callbacks: the megastep's gate
  refuses every zoo.SDF scene; sdf_nutbolt at f32, B 3072, 20 steps on the
  stage path with exactly one LDL and one Newton launch per step; the LDL
  kernel on its qM (n 6) and the Newton kernel on its rows (nv 6, 320
  rows) against their plain versions at f64 and f32, timed beside their
  bounds; every zoo.SDF scene card = CPU at f64; the callback scene card =
  CPU at f64."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import (forward, linalg_cuda, megastep_cuda,
                                    newton_cuda, smooth, solver)
  from mujoco_tpu_torch.parallel import rollout
  name = "sdf_nutbolt"
  for scene in zoo.SDF:
    mm = zoo.load(scene, torch.float32, "cuda")
    if megastep_cuda.supported(mm) or rollout.megastep_eligible(
        mm, rollout.make_batch(mm, 2), rollout.make_batch(mm, 1)):
      raise AssertionError(f"the megastep admits {scene}")
  print(f"megastep gate: refuses all {len(zoo.SDF)} SDF scenes", flush=True)

  # the full width: 20 steps on the stage path
  m = zoo.load(name, torch.float32, "cuda")
  d0 = sdf_batch(name, m, B, 82)
  out, run = many_run(f"{name} (nv {m.nv}, {m.con.ncon} slots in "
                      f"{len(m.con.sdfgroups)} SDF groups, {m.efc.nefc} "
                      f"rows)", m, d0, SDF_NSTEP,
                      {"ldl_solve": 1.0, "newton_pyramidal": 1.0,
                       "megastep": 0.0})
  reset = int((out.time < SDF_NSTEP * float(m.opt.timestep) * 0.999)
              .sum().item())
  dd = forward.fwd_position(m, out)
  live = (dd.contact.dist < dd.contact.includemargin).float().sum(1)
  sdf_ms, sdf_kernels, sdf_wall = sdf_pass(m, out)
  step_ms = run["profile"]["device_busy_ms_per_step"]
  print(f"{name}: envs the guard reset {reset}; slots in contact per env at "
        f"the end {live.mean().item():.2f} (most {int(live.max().item())}); "
        f"the SDF collision pass per step: device {sdf_ms:.3f} ms of "
        f"{step_ms:.3f}, {sdf_kernels:.0f} device kernels, wall "
        f"{sdf_wall:.3f} ms", flush=True)
  del dd, out

  # the LDL kernel on the scene's qM (n 6), phase 2's tolerances
  ldl = {}
  for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
    mm = zoo.load(name, dtype, "cuda")
    d = smooth.crb(mm, smooth.com_pos(mm, smooth.kinematics(
        mm, sdf_batch(name, mm, B, 83))))
    h = d.qM.contiguous()
    g = torch.randn(d.qvel.shape, generator=torch.Generator(
        device="cuda").manual_seed(84), device="cuda", dtype=dtype)
    p = linalg_cuda.spd_solve_kernel(h, g)
    torch.cuda.synchronize()
    ref = linalg_cuda.spd_solve_plain(h, g)
    err = (p - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    print(f"ldl_solve {str(dtype)[6:]} B{B} n{h.shape[1]} on {name}'s qM: "
          f"max rel err {rel:.3e} (limit {tol:g})", flush=True)
    if not rel <= tol:
      raise AssertionError(f"ldl_solve disagrees on {name}'s qM")
    b_ms, by = ldl_bound(B, h.shape[1], dtype)
    ldl[str(dtype)[6:]] = dict(
        n=h.shape[1], max_abs_err=err, max_rel_err=rel,
        ms=cuda_ms_cold(lambda: linalg_cuda.spd_solve_kernel(h, g)),
        l2_warm_ms=device_ms(lambda: linalg_cuda.spd_solve_kernel(h, g)),
        plain_ms=cuda_ms_cold(lambda: linalg_cuda.spd_solve_plain(h, g)),
        library_ms=cuda_ms_cold(lambda: torch.linalg.solve(h, g)),
        bound_ms=b_ms, bound_by=by)
    e = ldl[str(dtype)[6:]]
    print(f"ldl_solve {str(dtype)[6:]} B{B} n{h.shape[1]}: kernel_ms "
          f"{e['ms']:.4f} (L2 flushed; L2-warm {e['l2_warm_ms']:.4f}) "
          f"plain_ms {e['plain_ms']:.4f} library_ms {e['library_ms']:.4f} "
          f"(torch.linalg.solve) bound_ms {b_ms:.5f} ({by})", flush=True)
    del h, g, d

  # the Newton kernel on the scene's rows at the scene's options (4
  # iterations, 8 linesearch steps): f64 B 256 under phase 11's rule, f32
  # at the full width by phase 3's statistical criteria
  it, ls = int(m.opt.iterations), int(m.opt.ls_iterations)

  def rows_state(mm, nb, seed):
    d = sdf_batch(name, mm, nb, seed)
    d = forward.fwd_acceleration(mm, forward.fwd_actuation(
        mm, forward.fwd_velocity(mm, forward.fwd_position(mm, d))))
    return d.replace(qacc_warmstart=0.9 * d.qacc_smooth)

  m64 = zoo.load(name, torch.float64, "cuda")
  args = solver.newton_args(m64, rows_state(m64, SDF_NEWTON_B64, 85))
  out_k = newton_cuda.newton_kernel(*args, it, ls)
  torch.cuda.synchronize()
  out_p = newton_cuda.newton_plain(*args, it, ls)
  viol = newton_violation(out_k, out_p)
  off, worst_other, table = newton_rows_gate(args, out_k, out_p, it, ls)
  unmatched = [row for row in table if row[1] == 0]
  print(f"newton f64 B{SDF_NEWTON_B64} nefc{m.efc.nefc} nv{m.nv} it{it} "
        f"ls{ls} on {name}'s rows: worst err / (1e-9 + 1e-9·|plain|) "
        + " ".join(f"{k} {v:.3f}" for k, v in viol.items())
        + f"; {len(off)} envs off elementwise (limit "
        f"{SDF_NEWTON_B64 // 100}), worst err / limit on the others "
        f"{worst_other:.3f}, replayed {table}", flush=True)
  if (len(off) > SDF_NEWTON_B64 // 100 or not worst_other <= 1.0
      or unmatched):
    raise AssertionError(f"newton on {name}'s rows: kernel and plain "
                         f"disagree")
  newton_f64 = dict(batch=SDF_NEWTON_B64, violation=viol, off_envs=off,
                    replay=table,
                    max_abs_err=(out_k[0] - out_p[0]).abs().max().item())
  del args, out_k, out_p, m64
  args = solver.newton_args(m, rows_state(m, B, 86))
  out_k = newton_cuda.newton_kernel(*args, it, ls)
  torch.cuda.synchronize()
  out_p = newton_cuda.newton_plain(*args, it, ls)
  f32_gate = newton_f32_gate(f"newton f32 B{B} nv{m.nv} it{it} ls{ls} on "
                             f"{name}'s rows", args, out_k, out_p, 0.85)
  del out_k, out_p
  bound_ms, by, dense_ms, _, kept_mean, kept_max = newton_bound(args, it, ls)
  occ = newton_cuda.occupancy(m.efc.nefc, m.nv, torch.float32)
  newton = dict(nv=m.nv, nefc=m.efc.nefc, iterations=it, ls_iterations=ls,
                bound_ms=bound_ms, bound_by=by, dense_bound_ms=dense_ms,
                kept_mean=kept_mean, kept_max=kept_max, **occ,
                ms=cuda_ms_cold(lambda: newton_cuda.newton_kernel(
                    *args, it, ls)),
                plain_ms=cuda_ms_cold(lambda: newton_cuda.newton_plain(
                    *args, it, ls), reps=5, warmup=1),
                max_abs_err=newton_f64["max_abs_err"])
  print(f"newton f32 B{B} nefc{m.efc.nefc} nv{m.nv} it{it} ls{ls} on "
        f"{name}'s rows: kernel_ms {newton['ms']:.4f} (L2 flushed) plain_ms "
        f"{newton['plain_ms']:.4f} bound_ms {bound_ms:.5f} ({by}; kept rows "
        f"mean {kept_mean:.2f}, most {kept_max}; dense {dense_ms:.5f}); "
        f"{occ['threads']} threads per env, {occ['blocks_per_sm']} "
        f"blocks/SM", flush=True)
  del args
  torch.cuda.empty_cache()

  # card = CPU at f64, every SDF scene
  check = {}
  for scene in zoo.SDF:
    t0 = time.perf_counter()
    judged, largest, live = sdf_card_vs_cpu(scene)
    check[scene] = dict(judged_env_steps=judged, largest_move=largest,
                        live_slots=live, s=time.perf_counter() - t0)
    print(f"{scene} card vs CPU f64 B{SDF_CHECK_B} {SDF_CHECK_NSTEP} steps: "
          f"qpos, qvel and dist within 1e-8 ({live} slot-steps in contact), "
          f"env-steps judged by last-bit copies {judged} (largest move "
          f"{largest:g}; {check[scene]['s']:.1f} s)", flush=True)

  # the USER actuator, sensor and passive callbacks on the card
  t0 = time.perf_counter()
  cb_err = callback_check()
  print(f"callback scene (USER gain and bias, a USER sensor, a passive "
        f"callback) card vs CPU f64 B{SDF_CHECK_B} {CALLBACK_NSTEP} steps: "
        f"finite, largest |card − CPU| / (1 + |CPU|) {cb_err:.3e} (limit "
        f"1e-8; {time.perf_counter() - t0:.1f} s)", flush=True)

  details["sdf"] = dict(nutbolt=run, guard_resets=reset,
                        sdf_pass=dict(device_ms=sdf_ms, kernels=sdf_kernels,
                                      wall_ms=sdf_wall),
                        ldl_n6=ldl, newton_nv6=newton,
                        newton_nv6_f64_gate=newton_f64,
                        newton_nv6_f32_gate=f32_gate, card_vs_cpu=check,
                        callback_max_err=cb_err)
  report["ldl_solve"]["n6_sdf"] = ldl
  report["newton_pyramidal"]["nv6_sdf"] = newton
  for k in ("ldl_solve", "newton_pyramidal", "megastep"):
    report[k].setdefault("launches_by_path", {})[name] = run["launches"][k]


# ---- the MJCF compiler: phase 31

class no_pip_mujoco:
  """``import mujoco`` raises ImportError inside the block (a None entry
  in sys.modules); the entry as it was comes back afterwards."""

  def __enter__(self):
    self.old = sys.modules.get("mujoco", False)
    sys.modules["mujoco"] = None

  def __exit__(self, *exc):
    if self.old is False:
      sys.modules.pop("mujoco", None)
    else:
      sys.modules["mujoco"] = self.old


def compiled_models_equal(card, cpu, where="") -> float:
  """Every field of two CompiledModels: integers, bools, strings and the
  name tables exactly, floats within 1e-12 of max(1, |CPU|); fails
  otherwise. Returns the largest relative float difference."""
  from types import SimpleNamespace
  if sorted(vars(card)) != sorted(vars(cpu)):
    raise AssertionError(f"compiled fields differ{where}: "
                         f"{sorted(set(vars(card)) ^ set(vars(cpu)))}")
  worst = 0.0
  for k in sorted(vars(cpu)):
    a, b = getattr(card, k), getattr(cpu, k)
    if isinstance(b, SimpleNamespace):
      worst = max(worst, compiled_models_equal(a, b, f" {k}."))
      continue
    if not isinstance(b, np.ndarray) or b.dtype.kind != "f":
      same = (np.array_equal(a, b) if isinstance(b, np.ndarray)
              else a == b)
      if not same:
        raise AssertionError(f"compiled field{where}{k}: card {a!r} != "
                             f"CPU {b!r}")
      continue
    if a.shape != b.shape or a.dtype != b.dtype:
      raise AssertionError(f"compiled field{where}{k}: shape or dtype")
    if b.size:
      err = float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))
      if not err <= 1e-12:
        raise AssertionError(f"compiled field{where}{k}: card against CPU "
                             f"{err:.3e} > 1e-12")
      worst = max(worst, err)
  return worst


# the differences of the port's compile of humanoid.xml from the snapshot
# the pip mujoco wrote (CHANGES.md, the native build), field → largest
# |compile − snapshot|; every other field within 1e-8
SNAPSHOT_ALLOWED = {"opt.sleep_tolerance": 1e-4}
SNAPSHOT_VIS_COLOURS = 2.4e-8


def snapshot_differences(fields: dict, snap: dict) -> list:
  """The port's Model fields of the compiled humanoid against the
  committed snapshot's: fails on any difference but the allowed ones
  (unnamed actuators named, vis_meta within SNAPSHOT_VIS_COLOURS,
  SNAPSHOT_ALLOWED); returns every difference found, the allowed ones
  and those within 1e-8, as (field, largest |a − b|)."""
  extra = sorted(set(fields) - set(snap))
  if set(snap) - set(fields) or any(
      not re.fullmatch(r"names\.actuator\.actuator\d+", k) for k in extra):
    raise AssertionError(f"compiled humanoid fields against the snapshot: "
                         f"only compiled {extra}, only snapshot "
                         f"{sorted(set(snap) - set(fields))}")
  found = [(f"{len(extra)} unnamed actuators named (names.actuator."
            f"actuator0..{len(extra) - 1})", 0.0)] if extra else []
  for k in sorted(snap):
    a, b = np.asarray(fields[k]), np.asarray(snap[k])
    if a.shape != b.shape:
      raise AssertionError(f"compiled humanoid {k}: shape {a.shape} "
                           f"against the snapshot's {b.shape}")
    if a.dtype.kind != "f" or b.dtype.kind != "f":
      if not np.array_equal(a, b):
        raise AssertionError(f"compiled humanoid {k} differs from the "
                             f"snapshot")
      continue
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    if err == 0.0:
      continue
    found.append((k, err))
    limit = SNAPSHOT_ALLOWED.get(
        k, SNAPSHOT_VIS_COLOURS if k.startswith("vis_meta.") else 1e-8)
    if not err <= limit:
      raise AssertionError(f"compiled humanoid {k}: {err:.3e} from the "
                           f"snapshot, limit {limit:g}")
  return found


# the CPU side of phase 31, run in a process of its own beside the card's
# compiles (each host-bound on one core): the same two compiles with
# set_const on the CPU, saved with the port's serialize, with their seconds
COMPILE_ON_CPU = """
import json, os, sys, time
sys.modules["mujoco"] = None
import torch
torch.set_num_threads(1)
from mujoco_tpu_torch import compiler
from mujoco_tpu_torch.compiler import setconst
from mujoco_tpu_torch.models import snapshot, zoo
out = sys.argv[1]
lr_s = []
batch = setconst.length_ranges
def timed(*args):
  t = time.perf_counter()
  r = batch(*args)
  lr_s.append(time.perf_counter() - t)
  return r
setconst.length_ranges = timed
t0 = time.perf_counter()
cm = compiler.load_xml_path(os.path.join(zoo.XML_DIR, "humanoid.xml"),
                            device="cpu")
humanoid_s = time.perf_counter() - t0
compiler.save_model(cm, os.path.join(out, "humanoid.npz"))
t0 = time.perf_counter()
cm = compiler.load_xml(snapshot.MUSCLE_XML, device="cpu")
muscle_s = time.perf_counter() - t0
compiler.save_model(cm, os.path.join(out, "muscle.npz"))
with open(os.path.join(out, "seconds.json"), "w") as f:
  json.dump({"humanoid": humanoid_s, "muscle": muscle_s,
             "lengthrange": lr_s[0]}, f)
"""


def phase_compiler(report, details):
  """31: the MJCF compiler with no pip mujoco importable: humanoid.xml
  compiled with set_const on the card and on the CPU (equal), against the
  committed snapshot (1e-8 but the allowed differences), put on the card
  at f32 and run 200 steps at B 3072 in one megastep launch against the
  snapshot's run (check_f32); the muscle scene's length ranges (the LDL
  kernel's batch) on the card against the CPU and the snapshot (1e-9).
  The CPU compiles run in a process of their own, under the same guard,
  beside the card's."""
  import tempfile
  from mujoco_tpu_torch import compiler
  from mujoco_tpu_torch.compiler import setconst
  from mujoco_tpu_torch.models import io, snapshot, zoo
  from mujoco_tpu_torch.parallel import rollout
  card = card_line()
  path = os.path.join(zoo.XML_DIR, "humanoid.xml")
  tmp = tempfile.TemporaryDirectory()
  env = dict(os.environ, PYTHONPATH=os.pathsep.join(
      [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
  cpu_side = subprocess.Popen([sys.executable, "-c", COMPILE_ON_CPU,
                               tmp.name], env=env, cwd=ROOT)
  try:
    with no_pip_mujoco():
      try:
        import mujoco  # noqa: F401
      except ImportError:
        pass
      else:
        raise AssertionError("the import guard let mujoco in")
      # humanoid.xml on the card
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      cm = compiler.load_xml_path(path, device="cuda")
      torch.cuda.synchronize()
      card_s = time.perf_counter() - t0
      found = snapshot_differences(io.model_numpy(cm),
                                   zoo.load_snapshot("humanoid"))
      print(f"compiler: the compiled humanoid's Model at f64 against the "
            f"snapshot (limit 1e-8): {len(found)} differences:", flush=True)
      for k, err in found:
        print(f"  {k}: {err:.3e}", flush=True)

      # the main path on the compiled model
      m = io.put_model(cm, dtype=torch.float32, device="cuda")
      m_snap = zoo.humanoid(torch.float32)
      d = main_path_batch(m)
      fresh = io.make_data(m, device="cuda")
      torch.cuda.synchronize()
      reset_counts()
      t0 = time.perf_counter()
      out = rollout.scan_steps(m, d, NSTEP, fresh, check=True)
      torch.cuda.synchronize()
      wall = time.perf_counter() - t0
      launches = read_counts()
      finite = bool(torch.isfinite(out.qpos).all()
                    & torch.isfinite(out.qvel).all())
      print(f"compiler: compiled humanoid f32 B{B} {NSTEP} steps check=True: "
            f"wall {wall:.4f} s, launches {launches}, finite {finite}",
            flush=True)
      if not finite or launches != {"ldl_solve": 0, "newton_pyramidal": 0,
                                    "megastep": 1}:
        raise AssertionError(f"compiled humanoid: finite {finite}, "
                             f"launches {launches}: want one megastep "
                             f"launch")
      d_snap = main_path_batch(m_snap)
      out_snap = rollout.scan_steps(m_snap, d_snap, NSTEP,
                                    io.make_data(m_snap, device="cuda"),
                                    check=True)
      fracs = check_f32("compiled humanoid against the snapshot's",
                        {"qpos": out.qpos, "qvel": out.qvel},
                        {"qpos": out_snap.qpos, "qvel": out_snap.qvel})
      del out, out_snap, d, d_snap

      # the muscle scene: the length-range batch on the card, timed alone
      # through a wrapper of setconst.length_ranges
      lr_s = []
      batch = setconst.length_ranges

      def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = batch(*args)
        torch.cuda.synchronize()
        lr_s.append(time.perf_counter() - t)
        return res

      setconst.length_ranges = timed
      try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        mus = compiler.load_xml(snapshot.MUSCLE_XML, device="cuda")
        torch.cuda.synchronize()
        mus_card_s = time.perf_counter() - t0
        lr_launches = read_counts()
      finally:
        setconst.length_ranges = batch
    if cpu_side.wait(timeout=600) != 0:
      raise AssertionError(f"the CPU compiles exited {cpu_side.returncode}")
    with open(os.path.join(tmp.name, "seconds.json")) as f:
      cpu_times = json.load(f)
    # both sides through the same save and load, so that each field has
    # the same type on both
    compiler.save_model(cm, os.path.join(tmp.name, "humanoid_card.npz"))
    worst = compiled_models_equal(
        compiler.load_model(os.path.join(tmp.name, "humanoid_card.npz")),
        compiler.load_model(os.path.join(tmp.name, "humanoid.npz")))
    mus_cpu = compiler.load_model(os.path.join(tmp.name, "muscle.npz"))
  finally:
    if cpu_side.poll() is None:
      cpu_side.kill()
      cpu_side.wait()
    tmp.cleanup()
  print(f"compiler: humanoid.xml compiled in {card_s:.3f} s with set_const "
        f"on the card, {cpu_times['humanoid']:.3f} s on the CPU ({card}); "
        f"every field equal, floats within {worst:.3e} relative (limit "
        f"1e-12)", flush=True)
  nstep_lr = int(round(setconst.LR_INTTOTAL / setconst.LR_DT))
  need = 2 * int(mus.nu)
  lr = mus.actuator_lengthrange
  lr_snap = zoo.load_snapshot("muscle")["actuator_lengthrange"]
  gap_cpu = float(np.max(np.abs(lr - mus_cpu.actuator_lengthrange)))
  gap_snap = float(np.max(np.abs(lr - lr_snap)))
  per_step = {k: v / nstep_lr for k, v in lr_launches.items()}
  print(f"compiler: muscle scene (2 muscles on a limited hinge) compiled in "
        f"{mus_card_s:.3f} s on the card, {cpu_times['muscle']:.3f} s on the "
        f"CPU ({card}); the length-range batch of {need} envs x {nstep_lr} "
        f"steps: {lr_s[0]:.3f} s on the card, "
        f"{cpu_times['lengthrange']:.3f} s on the CPU, launches per step "
        f"{per_step}; lengthrange {lr.tolist()}, |card - CPU| "
        f"{gap_cpu:.3e}, |card - snapshot| {gap_snap:.3e} (limit 1e-9)",
        flush=True)
  if not (gap_cpu <= 1e-9 and gap_snap <= 1e-9):
    raise AssertionError("muscle lengthrange: card, CPU and snapshot "
                         "disagree")
  if lr_launches["ldl_solve"] < 2 * nstep_lr:
    raise AssertionError(f"length-range batch: {lr_launches} launches, "
                         f"want at least two LDL launches a step")
  details["compiler"] = dict(
      card=card, humanoid_card_s=card_s, humanoid_cpu_s=cpu_times["humanoid"],
      card_vs_cpu_max_rel=worst,
      snapshot_differences={k: e for k, e in found}, main_path=dict(
          batch=B, nstep=NSTEP, wall_s=wall, launches=launches,
          f32_fractions=fracs),
      muscle=dict(card_s=mus_card_s, cpu_s=cpu_times["muscle"],
                  lengthrange_card_s=lr_s[0],
                  lengthrange_cpu_s=cpu_times["lengthrange"],
                  envs=need, nstep=nstep_lr, launches=lr_launches,
                  launches_per_step=per_step, lengthrange=lr.tolist(),
                  card_vs_cpu=gap_cpu, card_vs_snapshot=gap_snap))
  for k in ("ldl_solve", "newton_pyramidal", "megastep"):
    paths = report[k].setdefault("launches_by_path", {})
    paths["compiled_humanoid"] = launches[k]
    paths["compiler_lengthrange"] = lr_launches[k]

# ---- the tools on top of the engine: phase 32

SYSID_NSTEP = 50
# the humanoid's 21 hinge dampings (the free joint's 6 dofs apart)
SYSID_SPEC = [("dof_damping", list(range(6, 27)))]
# the fit's start, a factor on the true dampings: from 1.2× or 1.05× the
# reference's Gauss-Newton (and the port's, step for step) leaves the
# basin on this 50-step run, from 1.01× it converges (PERF.md §6)
SYSID_START = 1.01
SYSID_MAX_ITER = 10
IK_OFFSET = (0.1, 0.0, 0.0)


def sysid_ctrls(nstep: int, nu: int) -> np.ndarray:
  """ctrl_j(t) = 0.3·sin(0.1·t + j), the sysid run's controls."""
  return 0.3 * np.sin(0.1 * np.arange(nstep)[:, None]
                      + np.arange(nu)[None, :])


def sysid_jacobian(device, observed):
  """(r, J) of the sysid fit's residual on the humanoid at f64 at the
  fit's start (the true dampings × SYSID_START), on ``device``."""
  from mujoco_tpu_torch import minimize, sysid
  from mujoco_tpu_torch.models import io, zoo
  m = zoo.humanoid(torch.float64, device)
  d0 = io.make_data(m, device=device)
  res = sysid.residual_fn(m, d0, sysid_ctrls(SYSID_NSTEP, m.nu), observed,
                          SYSID_SPEC)
  return minimize.jacobian(res, SYSID_START * sysid.get_params(m, SYSID_SPEC))


def ik_case(device):
  """IK on ``humanoid_sensors``: the ``hand_r`` site moved IK_OFFSET from
  its rest position, the free joint's 7 qpos held. Returns (result,
  the site's position at the result, the target)."""
  from mujoco_tpu_torch import minimize
  from mujoco_tpu_torch.models import io, zoo
  from mujoco_tpu_torch.ops import smooth
  m = zoo.load("humanoid_sensors", torch.float64, device)
  d = io.make_data(m, device=device)
  site = m.names["site"]["hand_r"]
  target = smooth.kinematics(m, d).site_xpos[0, site] + torch.tensor(
      IK_OFFSET, dtype=torch.float64, device=device)
  mask = np.ones(m.nq, dtype=bool)
  mask[:7] = False
  out = minimize.ik(m, d, site, target, joint_mask=mask)
  reached = smooth.kinematics(m, d.replace(qpos=out.x[None])).site_xpos[
      0, site]
  return out, reached, target


def seeded_box_qp(n=27, seed=32):
  """A box QP of order n from a numpy seed: (h, g, lower, upper)."""
  rng = np.random.default_rng(seed)
  a = rng.standard_normal((n, n))
  return (a @ a.T + n * np.eye(n), 2.0 * rng.standard_normal(n),
          -0.5 * np.abs(rng.standard_normal(n)),
          0.5 * np.abs(rng.standard_normal(n)))


def seeded_band(ntotal=27, nband=3, ndense=6, seed=33):
  """An SPD band-dense matrix (ntotal, nband, ndense) and a vector from a
  numpy seed."""
  rng = np.random.default_rng(seed)
  a = rng.standard_normal((ntotal, ntotal))
  spd = a @ a.T + ntotal * np.eye(ntotal)
  from mujoco_tpu_torch.utils import math as mjm
  return (mjm.dense_to_band(torch.as_tensor(spd), ntotal, nband,
                            ndense).numpy(), rng.standard_normal(ntotal))


def small_solves(device):
  """``box_qp`` and ``chol_solve_band`` on the seeded problems, at f64."""
  from mujoco_tpu_torch.utils import math as mjm
  put = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
  x, conv = mjm.box_qp(*(put(a) for a in seeded_box_qp()))
  mat, vec = seeded_band()
  shape = (27, 3, 6)
  sol = mjm.chol_solve_band(mjm.chol_factor_band(put(mat), *shape),
                            put(vec), *shape)
  return x.cpu().numpy(), bool(conv), sol.cpu().numpy()


# the CPU side of phase 32, run in a process of its own beside the card's
# fit: the sysid Jacobian at the fit's start, the IK solve and the small
# solves with the plain versions, with their seconds
TOOLS_ON_CPU = """
import json, os, sys, time
import numpy as np, torch
# two threads, so that the card's process, bound by its host, keeps the
# other cores
torch.set_num_threads(2)
import chip_smoke
out = sys.argv[1]
t0 = time.perf_counter()
r, jac = chip_smoke.sysid_jacobian("cpu", np.load(os.path.join(out,
                                                     "observed.npy")))
jac_s = time.perf_counter() - t0
t0 = time.perf_counter()
ik, reached, target = chip_smoke.ik_case("cpu")
ik_s = time.perf_counter() - t0
box, conv, band = chip_smoke.small_solves("cpu")
np.savez(os.path.join(out, "cpu.npz"), r=r.numpy(), jac=jac.numpy(),
         ik=ik.x.numpy(), box=box, band=band)
with open(os.path.join(out, "cpu.json"), "w") as f:
  json.dump({"jacobian_s": jac_s, "ik_s": ik_s, "ik_niter": ik.niter,
             "box_converged": conv}, f)
"""


def phase_tools(report, details):
  """32: the tools on top of the engine. sysid on the humanoid at f64
  (the 21 hinge dampings from 1.2× their values against the port's own
  50-step run at the true ones): the Jacobian at the start on the card
  against the CPU's, at least one LDL and one Newton launch per step of
  its rollout, the fit back on the true values within 1e-6 relative; IK
  on ``humanoid_sensors`` (card = CPU, the site on its target); testspeed
  of the humanoid from its snapshot and its XML (one megastep launch per
  timed call); the printer, box QP and banded Cholesky card = CPU; the
  multi-device dry run on the card; ``io._tree_topology`` of
  ``multi_humanoid10`` timed on the host. The CPU side runs in a process
  of its own beside the card's fit."""
  import tempfile
  from mujoco_tpu_torch import sysid, testspeed
  from mujoco_tpu_torch.models import io, printer, zoo
  from mujoco_tpu_torch.parallel.dryrun import dryrun_multichip
  card = card_line()
  m = zoo.humanoid(torch.float64, "cuda")
  d0 = io.make_data(m, device="cuda")
  ctrls = sysid_ctrls(SYSID_NSTEP, m.nu)
  x_true = sysid.get_params(m, SYSID_SPEC)
  observed = sysid.simulate(m, d0, ctrls)
  tmp = tempfile.TemporaryDirectory()
  np.save(os.path.join(tmp.name, "observed.npy"), observed.cpu().numpy())
  env = dict(os.environ, PYTHONPATH=os.pathsep.join(
      [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
  cpu_side = subprocess.Popen([sys.executable, "-c", TOOLS_ON_CPU, tmp.name],
                              env=env, cwd=ROOT)
  try:
    # the Jacobian at the start, its rollout's launches counted
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    r0, jac = sysid_jacobian("cuda", observed)
    torch.cuda.synchronize()
    jac_s = time.perf_counter() - t0
    jac_launches = read_counts()
    per_step = {k: v / SYSID_NSTEP for k, v in jac_launches.items()}
    # the fit
    m_start = sysid.apply_params(m, SYSID_SPEC, SYSID_START * x_true)
    reset_counts()
    t0 = time.perf_counter()
    fit = sysid.fit(m_start, d0, ctrls, observed, SYSID_SPEC,
                    max_iter=SYSID_MAX_ITER)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = read_counts()
    rel = float(((fit.x - x_true).abs() / x_true.abs()).max())
    trips = min(fit.niter + 1, SYSID_MAX_ITER)
    # IK, printer and the small solves on the card
    ik, reached, target = ik_case("cuda")
    ik_miss = float((reached - target).abs().max())
    text_card = printer.print_model(m)
    box, box_conv, band = small_solves("cuda")
    if cpu_side.wait(timeout=600) != 0:
      raise AssertionError(f"the CPU side exited {cpu_side.returncode}")
    cpu = dict(np.load(os.path.join(tmp.name, "cpu.npz")))
    with open(os.path.join(tmp.name, "cpu.json")) as f:
      cpu_times = json.load(f)
  finally:
    if cpu_side.poll() is None:
      cpu_side.kill()
      cpu_side.wait()
    tmp.cleanup()
  jac_gap = float(np.abs(jac.cpu().numpy() - cpu["jac"]).max()
                  / np.abs(cpu["jac"]).max())
  cost0 = 0.5 * float((r0 * r0).sum())
  print(f"sysid humanoid f64: {len(x_true)} dampings from "
        f"{SYSID_START}x, {SYSID_NSTEP} steps, max_iter {SYSID_MAX_ITER}: "
        f"{fit.niter} iterations before the freeze ({trips} trips), cost "
        f"{cost0:.6e} -> {float(fit.cost):.6e}, largest relative error of "
        f"x {rel:.3e} (limit 1e-6); fit {fit_s:.2f} s, {fit_s / trips:.2f} "
        f"s per trip, launches {fit_launches} ({card})", flush=True)
  print(f"sysid Jacobian rollout (B {len(x_true)}, {SYSID_NSTEP} steps): "
        f"{jac_s:.2f} s on the card, {cpu_times['jacobian_s']:.2f} s on the "
        f"CPU; launches per step {per_step}; largest |card - CPU| over the "
        f"largest |CPU| {jac_gap:.3e} (limit 1e-8)", flush=True)
  if not jac_gap <= 1e-8:
    raise AssertionError(f"sysid Jacobian: card against CPU {jac_gap:.3e}")
  if not rel <= 1e-6:
    raise AssertionError(f"sysid: dampings off by {rel:.3e} relative")
  if (per_step["ldl_solve"] < 1 or per_step["newton_pyramidal"] < 1
      or fit_launches["megastep"]):
    raise AssertionError(f"sysid Jacobian rollout launches {jac_launches}: "
                         f"want at least one LDL and one Newton a step")
  ik_gap = float(np.abs(ik.x.cpu().numpy() - cpu["ik"]).max())
  print(f"ik humanoid_sensors hand_r moved {IK_OFFSET} m, free joint held: "
        f"{ik.niter} iterations, site off its target by {ik_miss:.3e} m "
        f"(limit 1e-6), |x card - CPU| {ik_gap:.3e} (limit 1e-8)",
        flush=True)
  if not (ik_miss <= 1e-6 and ik_gap <= 1e-8):
    raise AssertionError("ik: the site misses its target or card != CPU")
  box_gap = float(np.abs(box - cpu["box"]).max())
  band_gap = float(np.abs(band - cpu["band"]).max())
  text_cpu = printer.print_model(zoo.humanoid(torch.float64, "cpu"))
  print(f"print_model humanoid card == CPU: {text_card == text_cpu} "
        f"({len(text_card.splitlines())} lines); box_qp n 27 |card - CPU| "
        f"{box_gap:.3e}, converged {box_conv}; chol_solve_band (27, 3, 6) "
        f"|card - CPU| {band_gap:.3e} (limit 1e-12)", flush=True)
  if text_card != text_cpu or not (box_gap <= 1e-12 and band_gap <= 1e-12):
    raise AssertionError("printer, box_qp or chol_solve_band: card != CPU")

  # testspeed of the humanoid, from its snapshot and from its XML
  speeds = {}
  for label, model in (("snapshot", "humanoid"),
                       ("xml", os.path.join(zoo.XML_DIR, "humanoid.xml"))):
    reset_counts()
    out = testspeed.main([model, "--nbatch", str(B), "--nstep",
                          str(NSTEP)])
    both = read_counts()
    # the first call and the timed one, one megastep launch each
    if not out["finite"] or out["launches"] != {
        "ldl_solve": 0, "newton_pyramidal": 0, "megastep": 1} or both != {
            "ldl_solve": 0, "newton_pyramidal": 0, "megastep": 2}:
      raise AssertionError(f"testspeed {label}: {out}, both calls {both}")
    speeds[label] = out
  main_sps = details.get("main_path", {}).get("env_steps_per_s")
  print(f"testspeed humanoid f32 B{B} {NSTEP} steps: "
        f"{speeds['snapshot']['env_steps_per_s']:.1f} env-steps/s from the "
        f"snapshot, {speeds['xml']['env_steps_per_s']:.1f} from the XML, "
        f"phase 5's {main_sps if main_sps is None else f'{main_sps:.1f}'} "
        f"({card})", flush=True)

  heights = dryrun_multichip(["cuda"])
  snap = zoo.load_snapshot("multi_humanoid10")
  t0 = time.perf_counter()
  io._tree_topology(snap["body_parentid"], snap["body_dofadr"],
                    snap["body_dofnum"], snap["dof_parentid"],
                    int(snap["nv"]), snap["dof_jntid"], snap["jnt_type"],
                    snap["jnt_dofadr"])
  topo_s = time.perf_counter() - t0
  print(f"io._tree_topology multi_humanoid10 (nv {int(snap['nv'])}): "
        f"{topo_s:.4f} s on the card's host", flush=True)
  details["tools"] = dict(
      card=card, sysid=dict(
          nstep=SYSID_NSTEP, nparam=len(x_true), start=SYSID_START,
          max_iter=SYSID_MAX_ITER, niter=fit.niter, trips=trips,
          cost_start=cost0, cost_end=float(fit.cost), max_rel_err=rel,
          fit_s=fit_s, s_per_trip=fit_s / trips, fit_launches=fit_launches,
          jacobian_card_s=jac_s,
          jacobian_cpu_s=cpu_times["jacobian_s"], jacobian_gap=jac_gap,
          jacobian_launches=jac_launches, launches_per_step=per_step),
      ik=dict(niter=ik.niter, miss_m=ik_miss, card_vs_cpu=ik_gap,
              cpu_s=cpu_times["ik_s"]),
      box_qp_gap=box_gap, band_gap=band_gap,
      testspeed={k: {kk: v[kk] for kk in ("env_steps_per_s", "first_s",
                                          "run_s", "route", "launches")}
                 for k, v in speeds.items()},
      dryrun=heights, tree_topology_multi_humanoid10_s=topo_s)
  for k in ("ldl_solve", "newton_pyramidal", "megastep"):
    paths = report[k].setdefault("launches_by_path", {})
    paths["sysid_jacobian"] = jac_launches[k]
    paths["testspeed"] = sum(v["launches"][k] for v in speeds.values())


# phase 33: the leaves past the control loop's eighteen
ENV_PIXEL_LEAVES = ("geom_size", "jnt_range")   # with the render leaves
TENDON_LEAVES = ("tendon_stiffness", "tendon_damping", "tendon_frictionloss",
                 "tendon_range", "tendon_lengthspring", "tendon_armature",
                 "tendon_margin", "tendon_solref_lim", "tendon_solimp_lim",
                 "tendon_solref_fri", "tendon_solimp_fri")
ACTUATOR_LEAVES = ("actuator_dynprm", "actuator_ctrlrange",
                   "actuator_forcerange")
ENV_SIDE_NSTEP = 20        # the side paths' f32 rollouts
ENV_CHECK_B = 256          # their f64 card-against-CPU batch
ENV_CHECK_NSTEP = 5
ENV_PIXEL_CHECK_B = 16     # the pixel loop's f64 card-against-CPU check
ENV_PIXEL_CHECK_SIZE = 32
ENV_PIXEL_CHECK_CONTROL = 2


def steps_of(step, nstep):
  """fn(d): nstep calls of step."""
  def run(d):
    for _ in range(nstep):
      d = step(d)
    return d
  return run


def env_pixel_card_vs_cpu(leaves):
  """The randomized pixel loop of humanoid_pixels at f64, B
  ENV_PIXEL_CHECK_B, ENV_PIXEL_CHECK_CONTROL control steps of
  PIXEL_NSTEP physics steps of ``step_randomized``, each step of the
  CPU's state on both (``randomized_card_vs_cpu``), then each control
  step's frames (32×32) of the CPU's state on both, judged by
  ``pixel_judge``. Returns (env-steps judged, pixels judged, pixels
  hit)."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import render
  bms = {}
  for dev in ("cuda", "cpu"):
    m = zoo.load("humanoid_pixels", torch.float64, dev)
    bms[dev] = control_randomize(m, ENV_PIXEL_CHECK_B, 100, leaves)[0]
  side = m.names["camera"]["side"]
  d = start_batch(m, ENV_PIXEL_CHECK_B, 101, "cpu")
  steps = pixels = hits = 0
  n = ENV_PIXEL_CHECK_SIZE
  for ctrl in pixel_controls(m, ENV_PIXEL_CHECK_B, 102)[
      :ENV_PIXEL_CHECK_CONTROL]:
    d = d.replace(ctrl=torch.as_tensor(ctrl, dtype=torch.float64))
    judged, d = randomized_card_vs_cpu(bms["cuda"], bms["cpu"], d,
                                       PIXEL_NSTEP, ("qpos", "qvel"))
    steps += judged
    dh = rebuild_frames(bms["cpu"], d)
    dc = rebuild_frames(bms["cuda"], d.to("cuda"))
    cpu = render.render(bms["cpu"], dh, side, n, n)
    card = render.render(bms["cuda"], dc, side, n, n)
    pixels += pixel_judge(card, cpu, bms["cuda"], bms["cpu"], dc, dh, side,
                          n, RENDER_TOL)
    hits += int((cpu[2] >= 0).sum())
  return steps, pixels, hits


def control_randomize(m, nbatch, seed, leaves):
  """randomize_model of m with ``leaves`` drawn by ``control_leaves``."""
  from mujoco_tpu_torch.parallel import rollout
  return rollout.randomize_model(m, control_leaves(m, nbatch, seed, leaves))


def env_side_path(report, tag, load, leaves, start, fields, seed):
  """A randomized side path: ``step_randomized`` of the Model load(dtype,
  device) gives, at f32 with ``leaves`` per env, ENV_SIDE_NSTEP steps at
  B 3072 from start(m, B, seed) (finite, one LDL and one Newton launch per
  step), env-steps/s and the idle share of a profiled 3-step window; then
  ENV_CHECK_NSTEP steps at f64, B ENV_CHECK_B, card = CPU
  (``randomized_card_vs_cpu``)."""
  from mujoco_tpu_torch.ops import megastep_cuda
  from mujoco_tpu_torch.parallel import rollout
  m = load(torch.float32, "cuda")
  bm, axes = control_randomize(m, B, seed, leaves)
  if megastep_cuda.supported(bm):
    raise AssertionError(f"the megastep admits a per-env {tag}")
  step = lambda d: rollout.step_randomized(bm, axes, d)
  out, wall, launches = step_loop(step, start(m, B, seed + 1),
                                  ENV_SIDE_NSTEP)
  finite = all(bool(torch.isfinite(getattr(out, f)).all()) for f in fields)
  want = {"ldl_solve": ENV_SIDE_NSTEP, "newton_pyramidal": ENV_SIDE_NSTEP,
          "megastep": 0}
  if not finite or launches != want:
    raise AssertionError(f"{tag} f32: finite {finite}, launches {launches}")
  prof = profile_window(lambda: (steps_of(step, 3)(out),
                                 torch.cuda.synchronize()), 3)[0]
  rate = B * ENV_SIDE_NSTEP / wall
  bms = {}
  for dev in ("cuda", "cpu"):
    bms[dev] = control_randomize(load(torch.float64, dev), ENV_CHECK_B, seed,
                                 leaves)[0]
  judged, _ = randomized_card_vs_cpu(
      bms["cuda"], bms["cpu"], start(bms["cpu"], ENV_CHECK_B, seed + 1,
                                     "cpu"), ENV_CHECK_NSTEP, fields)
  for k in ("ldl_solve", "newton_pyramidal"):
    report[k].setdefault("launches_by_path", {})[f"randomized_{tag}"] = (
        launches[k])
  print(f"randomized {tag}: {len(bm.env_leaves)} leaves per env "
        f"({', '.join(bm.env_leaves)}), f32 B{B} {ENV_SIDE_NSTEP} steps of "
        f"step_randomized: {rate:.1f} env-steps/s, "
        f"{launches['ldl_solve'] / ENV_SIDE_NSTEP} LDL and "
        f"{launches['newton_pyramidal'] / ENV_SIDE_NSTEP} Newton launches "
        f"per step, idle {prof['device_idle_share']:.2%} of a profiled "
        f"3-step window ({prof['kernel_launches_per_step']:.1f} device "
        f"kernels per step); f64 B{ENV_CHECK_B} {ENV_CHECK_NSTEP} steps card "
        f"= CPU (1e-8 on {', '.join(fields)}; {judged} env-steps judged by "
        f"last-bit copies)", flush=True)
  return dict(leaves=list(bm.env_leaves), env_steps_per_s=rate,
              launches=launches, idle_share=prof["device_idle_share"],
              kernels_per_step=prof["kernel_launches_per_step"],
              card_vs_cpu_judged=judged)


def phase_env_leaves(report, details):
  """33: the leaves past the eighteen. The pixel-RL loop of
  humanoid_pixels with every render leaf, geom_size and jnt_range drawn
  per env: f32, B 3072, 64×64, PIXEL_CONTROL control steps of
  PIXEL_NSTEP physics steps of ``step_randomized`` (one LDL and one
  Newton launch each; the megastep refuses a per-env Model), a frame of
  every env with the per-env Model after each; env-frames/s beside phase
  28's plain loop. The LDL and Newton kernels against their plain
  versions on the randomized humanoid's qM and rows (f64, B 3072); the
  randomized pixel loop at f64 card = CPU; the side paths
  humanoid_tendon with the eleven tendon leaves and quadruped_sim2real
  (implicitfast) with SIM2REAL_LEAVES and the three actuator leaves."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.models.types import Integrator
  from mujoco_tpu_torch.ops import megastep_cuda, render
  from mujoco_tpu_torch.parallel import rollout
  leaves = rollout.RENDER_LEAVES + ENV_PIXEL_LEAVES
  m = zoo.load("humanoid_pixels", torch.float32)
  bm, axes = control_randomize(m, B, 103, leaves)
  if megastep_cuda.supported(bm):
    raise AssertionError("the megastep admits a per-env humanoid_pixels")
  side = m.names["camera"]["side"]
  npix = PIXEL_SIZE * PIXEL_SIZE
  chunk = render.env_chunk(bm, rollout.make_batch(m, B), npix)
  controls = pixel_controls(m, B, 104)
  d0 = start_batch(m, B, 105)
  advance = steps_of(lambda d: rollout.step_randomized(bm, axes, d),
                     PIXEL_NSTEP)
  pixel_loop(bm, d0, controls[:1], side, pixel_gate, advance)   # warm
  torch.cuda.synchronize()
  reset_counts()
  seen, step_ms, frame_ms, wall = pixel_loop(bm, d0, controls, side,
                                             pixel_gate, advance)
  launches = read_counts()
  nphys = PIXEL_CONTROL * PIXEL_NSTEP
  if launches != {"ldl_solve": nphys, "newton_pyramidal": nphys,
                  "megastep": 0}:
    raise AssertionError(f"randomized pixel loop launches {launches}: want "
                         f"one LDL and one Newton launch per physics step")
  rate = B * PIXEL_CONTROL / wall
  plain = details.get("pixels", {}).get("env_frames_per_s")
  print(f"randomized pixel loop humanoid_pixels f32 B{B} {PIXEL_SIZE}² "
        f"{PIXEL_CONTROL} control steps of {PIXEL_NSTEP} step_randomized, "
        f"{len(bm.env_leaves)} leaves per env ({', '.join(bm.env_leaves)}): "
        f"{rate:.1f} env-frames/s (wall {wall:.3f} s; phase 28's plain "
        f"megastep loop {plain if plain is None else f'{plain:.1f}'}), "
        f"{launches['ldl_solve'] / nphys} LDL and "
        f"{launches['newton_pyramidal'] / nphys} Newton launches per "
        f"physics step, device: steps {step_ms:.3f} ms, frames "
        f"{frame_ms:.3f} ms (share {frame_ms / (step_ms + frame_ms):.2%}), "
        f"frames in chunks of {chunk} envs, the humanoid in at least "
        f"{seen:.2%} of envs", flush=True)
  for k in ("ldl_solve", "newton_pyramidal"):
    report[k].setdefault("launches_by_path", {})["randomized_pixels"] = (
        launches[k])
  del d0

  # the kernels on the randomized humanoid's qM and rows at f64
  m64 = zoo.load("humanoid_pixels", torch.float64)
  bm64, axes64 = control_randomize(m64, B, 103, leaves)
  kernels = path_kernels_gate(
      m64, "randomized humanoid_pixels",
      lambda d: rollout.step_randomized(bm64, axes64, d),
      start_batch(m64, B, 105))
  del bm64

  steps, pixels, hits = env_pixel_card_vs_cpu(leaves)
  print(f"randomized pixel loop f64 B{ENV_PIXEL_CHECK_B} "
        f"{ENV_PIXEL_CHECK_CONTROL} control steps card = CPU: qpos and qvel "
        f"within 1e-8 ({steps} env-steps judged by last-bit copies); frames "
        f"{ENV_PIXEL_CHECK_SIZE}² depth and RGB within {RENDER_TOL:g} where "
        f"seg agrees, {hits} pixels hit, {pixels} judged by last-bit "
        f"copies", flush=True)

  tendon = env_side_path(
      report, "humanoid_tendon",
      lambda dt, dev: zoo.load("humanoid_tendon", dt, dev), TENDON_LEAVES,
      control_state, ("qpos", "qvel"), 106)
  opt = {"integrator": int(Integrator.IMPLICITFAST)}
  sim2real = env_side_path(
      report, "quadruped_sim2real",
      lambda dt, dev: zoo.load("quadruped_sim2real", dt, dev, opt=opt),
      SIM2REAL_LEAVES + ACTUATOR_LEAVES, quadruped_batch, ACTUATION_FIELDS,
      108)
  details["env_leaves"] = dict(
      leaves=list(bm.env_leaves), env_frames_per_s=rate,
      plain_env_frames_per_s=plain, wall_s=wall, launches=launches,
      steps_device_ms=step_ms, frames_device_ms=frame_ms, chunk=chunk,
      humanoid_seen=seen, kernels=kernels,
      card_vs_cpu=dict(env_steps_judged=steps, pixels_judged=pixels,
                       pixels_hit=hits),
      humanoid_tendon=tendon, quadruped_sim2real=sim2real)


# phase 34: scan_steps over a mesh, the frame and contact leaves, the
# examples
MESH_REPS = 3              # timed calls of each megastep rollout
SIM2REAL_NEW_LEAVES = ("geom_pos", "geom_quat", "site_pos", "site_quat",
                       "site_size", "body_iquat", "jnt_pos", "jnt_axis",
                       "geom_margin", "geom_solmix", "jnt_margin",
                       "opt.impratio")
PAIR_LEAVES = ("pair_friction", "pair_solref", "pair_solreffriction",
               "pair_solimp", "pair_margin", "pair_gap")
PAIR_CHECK_B = 64
EXAMPLES_TIMEOUT = 240


def mesh_rollouts(details):
  """The humanoid at f32, B 3072, NSTEP steps from the main path's start:
  the plain ``scan_steps``, a mesh of the one card (one megastep launch,
  bitwise the plain call's state) and a mesh of the card twice (two
  launches, each of B/2 envs on its stream; each env held to the unsplit
  call bitwise, else by phase 4's f32 rule); env-steps/s of each, the
  best of MESH_REPS timed calls."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.parallel import rollout
  m = zoo.humanoid(torch.float32)
  d = main_path_batch(m)
  meshes = {"plain": None, "mesh_1": ["cuda:0"],
            "mesh_2": ["cuda:0", "cuda:0"]}
  out, rates, launches = {}, {}, {}
  for tag, mesh in meshes.items():
    run = lambda: rollout.scan_steps(m, d, NSTEP, mesh=mesh)
    run()                                                  # warm
    torch.cuda.synchronize()
    reset_counts()
    out[tag] = run()
    torch.cuda.synchronize()
    launches[tag] = read_counts()
    walls = []
    for _ in range(MESH_REPS):
      t0 = time.perf_counter()
      run()
      torch.cuda.synchronize()
      walls.append(time.perf_counter() - t0)
    rates[tag] = B * NSTEP / min(walls)
  want = {"plain": 1, "mesh_1": 1, "mesh_2": 2}
  for tag, n in want.items():
    if launches[tag] != {"ldl_solve": 0, "newton_pyramidal": 0,
                         "megastep": n}:
      raise AssertionError(f"scan_steps {tag}: launches {launches[tag]}, "
                           f"want {n} megastep launch(es) and no other")
  state = lambda o: {f: getattr(o, f) for f in rollout.STATE_FIELDS}
  bitwise = {tag: all(torch.equal(a, b) for a, b in zip(
      state(out[tag]).values(), state(out["plain"]).values()))
      for tag in ("mesh_1", "mesh_2")}
  if not bitwise["mesh_1"]:
    raise AssertionError("scan_steps(mesh=[cuda:0]) is not the plain call")
  fracs = None
  if not bitwise["mesh_2"]:
    fracs = check_f32("mesh of two against the unsplit call",
                      state(out["mesh_2"]), state(out["plain"]))
  if out["mesh_2"].qpos.shape != out["plain"].qpos.shape:
    raise AssertionError("scan_steps over a mesh lost envs")
  print(f"scan_steps over a mesh: humanoid f32 B{B} {NSTEP} steps, "
        f"env-steps/s plain {rates['plain']:.1f}, mesh [cuda:0] "
        f"{rates['mesh_1']:.1f} (1 megastep launch, bitwise the plain "
        f"call), mesh [cuda:0, cuda:0] {rates['mesh_2']:.1f} (2 megastep "
        f"launches of {B // 2} envs, no LDL or Newton launch; "
        + ("bitwise the unsplit call" if bitwise["mesh_2"] else
           "by phase 4's f32 rule: " + " ".join(
               f"{k} {v:.2%}" for k, v in fracs.items()))
        + f"); best of {MESH_REPS} calls", flush=True)
  details["mesh"] = dict(env_steps_per_s=rates, launches=launches,
                         bitwise=bitwise, f32_fractions=fracs)
  return launches


def pair_card_vs_cpu():
  """pair_condim6 (a condim-6 explicit pair) at f64 with the six pair
  leaves per env, B PAIR_CHECK_B, ENV_CHECK_NSTEP steps: card = CPU
  (``randomized_card_vs_cpu``) from the scene's start, the ball 1 cm in
  the floor, so that the pair acts from the first step."""
  from mujoco_tpu_torch.models import zoo
  bms = {}
  for dev in ("cuda", "cpu"):
    m = zoo.load("pair_condim6", torch.float64, dev)
    bms[dev] = control_randomize(m, PAIR_CHECK_B, 110, PAIR_LEAVES)[0]
  d = start_batch(bms["cpu"], PAIR_CHECK_B, 111, "cpu")
  judged, out = randomized_card_vs_cpu(bms["cuda"], bms["cpu"], d,
                                       ENV_CHECK_NSTEP, ("qpos", "qvel"))
  if not bool(torch.isfinite(out.qpos).all()):
    raise AssertionError("pair_condim6 per env: non-finite state")
  return dict(leaves=list(bms["cpu"].env_leaves), env_steps_judged=judged)


def run_examples() -> dict:
  """The examples_torch scripts at their defaults, each in a process of
  its own on the card: exit 0 and its seconds; rollout_batch (timed
  alone, first) makes one megastep launch; procedural_model and sysid_fit
  (one env each, host-bound) run side by side; sysid_fit recovers the
  damping."""
  env = {k: v for k, v in os.environ.items()
         if not k.startswith("EX_") and k != "PYTHONPATH"}
  out = {}
  for batch in (("rollout_batch.py",), ("procedural_model.py",
                                        "sysid_fit.py")):
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join("examples_torch", name)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in batch}
    secs, results = {}, {}
    try:
      for name, p in procs.items():
        results[name] = p.communicate(timeout=EXAMPLES_TIMEOUT)
        secs[name] = time.perf_counter() - t0
    finally:
      for p in procs.values():
        if p.poll() is None:
          p.kill()
          p.wait()
    for name, p in procs.items():
      stdout, stderr = results[name]
      last = stdout.strip().splitlines()[-1] if stdout.strip() else ""
      print(f"example {name}: exit {p.returncode} in {secs[name]:.1f} s"
            f"{' (side by side)' if len(batch) > 1 else ''}: {last}",
            flush=True)
      if p.returncode != 0:
        raise AssertionError(f"examples_torch/{name} failed:\n{stdout}\n"
                             f"{stderr[-4000:]}")
      if name == "rollout_batch.py" and "1 megastep launch" not in last:
        raise AssertionError(f"rollout_batch: {last}")
      if name == "sysid_fit.py":
        x = float(re.search(r"recovered ([0-9.]+)", last).group(1))
        if abs(x - 0.27) > 1e-4:
          raise AssertionError(f"sysid_fit: {last}")
      out[name] = dict(seconds=secs[name], last_line=last,
                       side_by_side=len(batch) > 1)
  return out


def phase_mesh_leaves(report, details):
  """34: ``scan_steps(mesh=)`` (``mesh_rollouts``); quadruped_sim2real
  (implicitfast) with the frame and contact leaves it reaches beside its
  phase-33 leaves, f32 B 3072, ENV_SIDE_NSTEP steps of
  ``step_randomized`` (one LDL and one Newton launch each), its idle
  share, card = CPU at f64 (``env_side_path``), and the LDL and Newton
  kernels against their plain versions on its f64 qM and rows; the pair
  leaves on pair_condim6 card = CPU; the three examples."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.models.types import Integrator
  from mujoco_tpu_torch.parallel import rollout
  launches = mesh_rollouts(details)
  report["megastep"].setdefault("launches_by_path", {}).update(
      mesh_1=launches["mesh_1"]["megastep"],
      mesh_2=launches["mesh_2"]["megastep"])
  opt = {"integrator": int(Integrator.IMPLICITFAST)}
  load = lambda dt, dev: zoo.load("quadruped_sim2real", dt, dev, opt=opt)
  leaves = SIM2REAL_LEAVES + ACTUATOR_LEAVES + SIM2REAL_NEW_LEAVES
  sim2real = env_side_path(report, "quadruped_sim2real_frames", load,
                           leaves, quadruped_batch, ACTUATION_FIELDS, 112)
  m64 = load(torch.float64, "cuda")
  bm64, axes64 = control_randomize(m64, B, 112, leaves)
  kernels = path_kernels_gate(
      m64, "randomized quadruped_sim2real (frames, contact)",
      lambda d: rollout.step_randomized(bm64, axes64, d),
      quadruped_batch(m64, B, 113))
  del bm64
  pair = pair_card_vs_cpu()
  print(f"pair_condim6 per env ({', '.join(pair['leaves'])}): f64 "
        f"B{PAIR_CHECK_B} {ENV_CHECK_NSTEP} steps card = CPU (qpos and qvel "
        f"within 1e-8; {pair['env_steps_judged']} env-steps judged by "
        f"last-bit copies)", flush=True)
  examples = run_examples()
  details["mesh_leaves"] = dict(quadruped_sim2real=sim2real, kernels=kernels,
                                pair_condim6=pair, examples=examples)


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    return 1
  sys.path.insert(0, ROOT)
  from mujoco_tpu_torch.ops import cuda_build
  card = card_line()
  print(f"card: {card}", flush=True)
  print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda}", flush=True)
  t0 = time.perf_counter()
  cuda_build.library()
  build_s = time.perf_counter() - t0
  print(f"kernels built and loaded in {build_s:.1f} s", flush=True)

  report, details = {}, {"card": card, "build_s": build_s, "phase_s": {}}
  phases = (phase_ldl, phase_newton, phase_megastep,
            lambda r, d: phase_stage_clock(d), phase_main_path,
            phase_stage_path, lambda r, d: phase_profile(d),
            lambda r, d: phase_cross_check(d), phase_general_core,
            phase_model_class, phase_newton_rows, phase_ldl_backward,
            phase_multi_humanoid, phase_newton_gradient, phase_slice_scenes,
            phase_humanoid_elliptic, phase_rk4, phase_option_scenes,
            phase_islands, phase_dynamic_pairs, phase_sleep,
            phase_colliders, phase_convex_scenes, phase_sensors,
            phase_actuation, phase_control_loop, phase_flex, phase_pixels,
            phase_wide_megastep, phase_sdf, phase_compiler, phase_tools,
            phase_env_leaves, phase_mesh_leaves)
  for number, phase in zip(PHASE_NUMBERS, phases):
    t0 = time.perf_counter()
    phase(report, details)
    details["phase_s"][number] = time.perf_counter() - t0
    print(f"phase {number} done in {details['phase_s'][number]:.1f} s",
          flush=True)

  kernels = [report["ldl_solve"], report["newton_pyramidal"],
             report["megastep"]]
  details["kernels"] = kernels
  os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
  with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
    json.dump(details, f, indent=1)
  print(json.dumps({"kernels": kernels}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
