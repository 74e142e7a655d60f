#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card.

    python3 chip_smoke.py [--phases kernel_check,sparse_reference,...]

Needs one CUDA card, ``nvcc`` and the checkout (it imports the port from
the directory it lives in; it imports nothing of JAX).  Every phase
prints one JSON line (``at_s``: seconds since the start); any failure
raises, exits non-zero and prints no ``ok`` line.  ``--phases`` runs
only the named phases (device, build and the last lines always run);
the default is all of them.  The paths: the
dense main path (Kademlia + KBRTest under NoChurn at N=10,000), the
sparse path (the active-set tick under lifetime churn at 65,536 slots),
Chord + KBRTest on the dense tick at N=10,000 and on the sparse tick
under lifetime churn, the DHT path (Kademlia + DHT + DHTTestApp under
LifetimeChurn at 20,000 slots, verify.ini's stack) and the campaign path
(four replicas of Kademlia + KBRTest under LifetimeChurn at 20,000 slots
each, a seed and lifetime-mean sweep with telemetry rings), the service
path (the main path's configuration served window by window with
checkpoints, SIGKILLed in a child process and resumed) and the ingest
path (Kademlia + the echo app answering requests injected at window
boundaries, in-process and over local sockets), and the ini front end's
(the main path built from an ini, the CLI, ParetoChurn at 30,000 slots,
a 10,000-node dht.trace with a partition), Pastry under ParetoChurn at
30,000 slots, Koorde, Broose and EpiChord + KBRTest at N=10,000, the
main path over InetUnderlay's router topology, and GIA's random-walk
search at BASELINE config 4's 100,000 nodes (with Vast and Quon, the
game overlays, at 10,000), and NICE's application-layer multicast at
1,000 nodes (with PubSubMMOG, NTree over Chord and MyOverlay at
10,000), and Scribe's multicast with ALMTest over Chord at 10,000 nodes
(with SimMud, P2PNS, BroadcastTestApp and a TierStack at 10,000).
``--phases`` also takes the group names of ``GROUPS`` (``dense``,
``sparse``, ``chord``, ``dht``, ``campaign``, ``service``, ``ini``,
``pastry``, ``debruijn``, ``epichord``, ``inet``, ``gia``, ``vast``,
``alm``, ``scribe``).  Phases
whose depth was cut to keep the whole run inside its time limit print
``depth_cut`` (ticks before and after), and the CPU halves of the
``*reference`` phases run in one helper process (``cpu_half``), queued
at the start and stopped before the script exits, so that they overlap
the card's phases.  Phases:

  device        card name, count, and the nvidia-smi name/power line;
  build         nvcc builds of the CUDA kernels from csrc/ (in parallel),
                ptxas registers, stack frame and spills per kernel (a
                stack frame or a spill fails the run);
  kernel_check  each kernel against its plain PyTorch version (and the
                torch-ops oracles) — both inbox entries at N=10,000, at
                the sparse path's N=65,536 and at GIA's N=100,000 (P = 8
                N, R=16, W=31) on random,
                empty, full, R-overflow and hold-mask pools and on edge
                cases (one destination, equal times, N=1, N at a scan tile
                +-1); ``alloc_dest`` at P=80,000, Q=320,000 and at
                GIA's P=800,000, Q=3,200,000, and on edge
                cases (tile sizes, no free slot, all free, crossings inside
                a tile and on its edge, the sparse path's 0.1% wanted);
                ``compact_indices`` at m=65,536, cap=8,192 on random,
                empty and full masks, set counts of cap - 1, cap and
                cap + 1 and a mask viewed at a 1-byte offset, and at m = 0,
                1 and a tile +-1 under a cap above m; ``inbox_gather``
                (the gather step alone) at W in {1, 2, 4, 31, 32, 33}
                with N R W not a multiple of 4, all entries empty and all
                full.  Every case runs 50 times back to back: exact
                equality required;
  reference     the bench configuration at N=16 for 96 ticks on the card
                (kernels) and on the CPU (torch-ops oracle, held leaf-exact
                to the JAX package by tests/test_torch_kademlia.py):
                integer leaves equal, float leaves within 1e-12 relative;
  identity      5 ticks at N=10,000 from one state with
                inbox_impl="scatter" and "pallas": every leaf equal;
  main_path     Kademlia + KBRTest at N=10,000 (bench.py's configuration
                with 16 inbox and 32 outbox slots — with bench.py's 8 and
                16 the hot destinations' backlog grows without bound at
                this size, see PERF.md) on the kernels: warm-up to 25
                simulated s, a measured
                5 s window, the health gate (delivery >= 0.95, no pool or
                outbox overflow), each kernel's launch count (> 0);
  timing        each dense kernel on the inputs of one more main-path
                tick: ``device_ms`` (a CUDA graph of 20 calls replayed
                between CUDA events: the card's time alone), ``call_ms``
                (20 calls issued from the host between CUDA events, host
                work included), the device operations of one call
                (counted from a CUDA graph of it, their µs from
                torch.profiler) and the plain version's time; for the
                inbox kernel also ``hot_device_ms`` on the R-overflow case;
                and ``inbox_gather`` alone on the tick's selected inbox
                (checked 50 times against its plain version, timed beside
                ``torch.index_select`` in a CUDA graph);
  profile       torch.profiler over 1 more main-path tick: wall and
                device time per tick, device idle share, kernel launches
                per tick, the device ops that take the most time;
  sparse_reference  the sparse tick under lifetime churn at 24 slots for
                48 ticks on the card (kernels) and on the CPU (torch-ops
                oracle, held leaf-exact to the JAX package by
                tests/test_torch_sparse.py): integer leaves equal, float
                leaves within 1e-12 relative;
  sparse_identity  20,000 slots (lifetime mean 100 s) warmed to 10
                simulated s, then 10 ticks of sparse kernels vs sparse
                torch ops at the auto cap, and of sparse kernels at
                ``active_cap = n`` vs the dense kernel tick: every leaf
                equal, with churn firing inside the compared ticks;
  sparse_path   the sparse tick at 65,536 slots (32,768 target, lifetime
                mean 1000 s, 1% activity: test interval 20 s over a
                0.2 s window) on the kernels: warm-up to 30 simulated s,
                a measured 10 s window, the health gate, the awake share
                and each sparse-path kernel's launch count (> 0);
  sparse_timing the same for each sparse kernel (and
                ``torch.masked_select`` for the compaction) on the inputs
                of one more sparse tick, ``alloc_dest`` at Q = 2,097,152;
  sparse_profile  torch.profiler over a few more sparse ticks;
  chord_reference  Chord + KBRTest (bench.py's Chord configuration) at
                N=16 for 96 ticks on the card (kernels) and on the CPU
                (torch ops, held leaf-exact to the JAX package by
                tests/test_torch_chord.py): integer leaves equal, float
                leaves within 1e-12 relative;
  chord_path    the dense Chord path at N=10,000 on the kernels (16 inbox,
                32 outbox slots): warm-up to 25 s, a measured 5 s
                window; the gate is no pool or outbox overflow, lookups
                delivered and every dense kernel launched; delivery,
                failed lookups, lookups/s, ms per tick, hops and peak
                device memory are printed (delivery is not held to 0.95:
                the reference's own Chord delivers 0.71-0.79 at N=1,000,
                PERF.md); then ``chord_sync_check``;
  chord_identity  5 ticks from the Chord path's state, scatter vs
                kernels: every leaf equal;
  chord_profile torch.profiler over a few more Chord ticks;
  chord_sparse_reference  Chord's sparse tick under lifetime churn at 24
                slots for 48 ticks, card vs CPU, with the sparse kernels'
                launches counted over the card run;
  dht_reference Kademlia + DHT and Chord + DHT at 16 slots (target 8,
                lifetime mean 8 s, 1 s graceful leave, test interval
                2 s, normal draws off) for 72 ticks on the card
                (kernels) and on the CPU (torch ops, held leaf-exact to
                the JAX package by tests/test_torch_dht*.py): integer
                leaves equal, float leaves within 1e-12 relative; how
                often each DHT hook acted (replica fan-out, handover
                sends, update() stagings, Chord's urgent ones, maintenance
                puts), each > 0; the DHT's first-index picks (bool
                ``argmax``, ``argmin`` of expiries, the vote winner) on
                10,000 tied rows against a stable sort;
                (The card halves of ``ini_reference``,
                ``dht_reference``, ``campaign_reference``,
                ``pastry_reference`` and the four lane overlays'
                references run in child processes beside
                ``service_reference``, and their lines print after it.)
  dht_path      Kademlia + DHT + DHTTestApp (default.ini's DHT settings,
                a truth ring of 16,384 keys) under LifetimeChurn (10,000
                target, 20,000 slots, Weibull mean 1,000 s) on the dense
                kernels: warm-up to 100 simulated s (verify.ini's
                transition), a measured 10 s window; puts, gets, their
                success ratios, wrong and not-found gets, maintenance
                puts, DHT operations per wall second, ms per tick, peak
                memory, overflow, alive nodes and the ring cursor (the
                device ms, launches and idle share come from
                ``dht_profile``'s ticks).  Gate: no overflow, puts and
                gets > 0, both ratios within 0.1 of the reference's at
                N=1,000 in the same window (DHT_REFERENCE), every dense
                kernel launched;
  dht_sync_check  one more DHT tick with every host sync an error;
  dht_timing    ``timing`` for the dense kernels on the inputs of one
                more DHT tick (P = 160,000, Q = 640,000);
  dht_identity  5 ticks from the DHT path's state, scatter vs kernels:
                every leaf equal;
  dht_profile   torch.profiler over a few more DHT ticks;
  dht_sparse_reference  Kademlia + DHT on the sparse tick at 24 slots for
                48 ticks, card vs CPU, the sparse kernels' launches
                counted over the card run;
  campaign_reference  a campaign of Kademlia + KBRTest under lifetime
                churn at 16 slots, a grid over ``engine.window`` (0.1,
                0.2 s) and ``app.testMsgInterval`` (1, 2 s), S = 4, with
                a telemetry sample every 4 ticks into a ring of 8: 24
                ticks of ``run_chunk`` on the card (kernels) and on the
                CPU (torch ops, held leaf-exact to the JAX package's
                campaign by tests/test_torch_campaign.py), integer leaves
                equal and float leaves within 1e-12 relative; then
                ``run_until_device`` to 5 s on both (per-row time and
                tick equal); then a sparse-tick campaign of two rows for
                24 ticks, card vs CPU, its kernels' launches counted;
  campaign_path four replicas (two seeds from 7 at each lifetime mean of
                1,000 and 10,000 s) of Kademlia + KBRTest under
                LifetimeChurn at 20,000 slots each (10,000 target, the
                main path's widths) on the dense kernels, a telemetry
                sample every 5 ticks into a ring of 24: every row warmed
                to 25 simulated s by ``Campaign.run_until_device``, a
                measured 5 s window (cut from 45 and 10 s); per row the
                delivery, hops and overflow, the report's CIs, delivered
                lookups per wall second summed over rows, wall ms per
                campaign tick, peak memory.  Gate, per row: the health gate, one telemetry
                sample per 5 ticks and a wrapped ring; the report's
                delivery ratio over all four rows with a finite CI;
  campaign_profile  torch.profiler over 1 more campaign tick (launches
                per tick per replica);
  campaign_sync_check  one more campaign tick with every host sync an
                error;
  campaign_identity  4 campaign ticks from the path's rows against the
                same ticks stepped solo for rows 0 and 3 with their
                sweep overrides, and against campaigns of rows 0 and 3
                (``replica_ids``) on the torch-ops inbox and with
                telemetry off (the non-telemetry leaves): every leaf
                equal;
  service_path  the main path's state at 25 s saved as a checkpoint of
                window 0 (``checkpoint.save``); ``ServiceLoop.resume``
                from it for 8 windows of 1 simulated s (5 ticks, one
                chunk each), double-buffered, a checkpoint every 2
                windows written behind on a writer thread, every blocking
                host sync an error and the fetches counted (one per
                window); ``python -m oversim_tpu_torch.service --resume``
                from a copy in a child process, SIGKILLed once its
                checkpoint says 4 windows (return code -9, no ``.tmp``
                left); the parent resumes that file to 8 windows (writes
                on the launching thread, under torch.profiler).  Gate:
                every leaf and the summaries of windows 5-8 equal to the
                uninterrupted run's, the child's window summaries equal,
                another config hash refused, traffic and no overflow.
                Printed: wall ms per window, dispatch, fetch, the host's
                gap between windows with and without a checkpoint drain,
                checkpoint write ms and bytes, device idle share, peak
                memory, KBRTest delivery, launches per window;
  ingest_path   Kademlia + ``RealworldEchoApp(transform=5)`` at N=10,000
                (``ext_hold_slot=0``, the main path's widths) warmed to
                25 s, then 13 windows through ``InProcessIngest``: 8 of
                2,000 requests to uniform live slots, a burst of 20,000
                (two per node), 4 quiet.  Gate: all 36,000 answered
                ``(b, c + 5)``, no NACK, no pool or outbox overflow, one
                pool write per window with requests.  Then a
                ``RealtimeGateway`` behind ``GatewayIngest``: 256 UDP
                datagrams and 64 TCP frames from local sockets over 8
                windows (all to the gateway node), every one answered,
                one pool write per window with frames.  Printed: answered per wall second, wall ms
                per window, inject and drain ms, pool occupancy, inbox
                deferrals (the parked answers count there);
  ingest_alloc_check  ``alloc_dest`` at the inject call site on the
                ingest path's pool after the burst window (its 20,000
                answers parked): batches of 1, 2,000 and
                20,000 and a 2,000 batch into a pool with 1,000 free
                slots, 50 times each against its plain version and
                ``alloc_dest_cumsum``; the burst's ``inject_ext_batch``
                placing frame i in the plain placement's slot i;
  service_reference  tests/test_torch_service_resume.py's configurations
                (Kademlia and Chord under lifetime churn at 24 slots, and
                a campaign of 4 Kademlia rows) served 4 windows on the
                card with a checkpoint every 2; the file of window 2
                resumed to 4: every leaf equal to the uninterrupted card
                run, and to the CPU run (float leaves within 1e-12
                relative);
  ini_reference ParetoChurn, RandomChurn, pareto_shifted lifetimes, a
                trace-driven Kademlia + DHT with one DISCONNECT/CONNECT
                pair, and the sparse tick, each built from an ini at 16-24
                slots (normal draws off), 48 ticks (the trace 256) on the
                card (kernels) and on the CPU (torch ops, held leaf-exact
                to the JAX package by tests/test_torch_ini_run.py and
                test_torch_trace.py): integer leaves equal, float leaves
                within 1e-12 relative; the trace run's ``partition_lost``
                > 0; all four kernels launched;
  ini_identity  the main path's scenario written as an ini (``main_ini``)
                and built by ``config/scenario.py build_simulation`` with
                the main path's EngineParams (the lookup slots and the
                stagger's deviation, which the ini has no key for, set on
                the built simulation) against ``bench_sim``: the init
                state and 10 ticks, every leaf equal;
  cli_path      ``python -m oversim_tpu_torch`` in-process (stdout
                captured) on that ini at N=10,000 with the ini's own
                engine defaults (window 0.01 s, 8 / 16 slots) to 2.5
                simulated s (whole 256-tick chunks), ``--json``,
                ``--output-scalars`` and ``--output-vectors``.  Gate: exit
                0, the record parses with ``sim.time`` at least the
                horizon, the .sca and .vec parse, both dense kernels
                launched;
  cli_child     a child ``python -m oversim_tpu_torch ... --until 1`` at
                N=1,000, run beside ``service_reference`` and
                ``ini_reference`` (part of ``cli_path``).  Gate: exit 0
                and ``sim.time`` >= 1;
  pareto_path   BASELINE config 3's churn at full width: ParetoChurn
                (lifetime and dead-time means 1,000 s) under Kademlia +
                KBRTest from an ini at 10,000 target nodes (30,000 slots,
                P = 240,000, Q = 960,000), the main path's EngineParams on
                the kernels, warmed to 25 s, a measured 5 s window:
                lookups/s, wall and device ms per tick, idle share and
                launches (``pareto_profile``, 2 more ticks), peak memory,
                the alive population.  Gate: no overflow, alive within
                10% of 10,000, delivery >= 0.95 or within 0.1 of the
                reference's at N=1,000 in the same window
                (``PARETO_REFERENCE``, scripts/torch_pareto_health.py);
  pareto_timing ``timing`` for the dense kernels on the inputs of one
                more Pareto tick;
  trace_path    a dht.trace-format file from numpy seed 1 (10,000 JOINs
                over 20 s, 1,000 LEAVEs in 30-40 s, 20,000 PUTs and
                20,000 GETs on 5,000 keys, node types 0 and 1 split both
                ways from 25 to 30 s) parsed through the native scanner,
                Kademlia + DHT from an ini with the main path's
                EngineParams on the kernels to 45 s: DHT operations per
                wall second, put and get success, ``partition_lost``.
                Gate: no overflow, every trace command issued,
                ``partition_lost`` > 0;
  pastry_reference  recursive routing and Pastry at 16-24 slots (normal
                draws off), card (kernels) against CPU (torch ops, held
                leaf-exact to the JAX package by tests/test_torch_pastry*.py
                and test_torch_route_modes.py): Pastry semi-recursive and
                iterative and Bamboo with KBRTest one-way and RPC tests
                under lifetime churn, Chord in the semi, full and source
                modes with the same app, Pastry + DHT built from an ini and
                driven by ``tiny_trace()`` (BASELINE config 3's stack), and
                Pastry on the sparse tick; 48 ticks (the DHT run 80),
                integer leaves equal, float leaves within 1e-12 relative;
                all four kernels launched (their counts printed).  The
                card half runs in a child process (``pastry_card_half``)
                beside ``service_reference`` and ``ini_reference``, whose
                card work is compared, not timed;
  pastry_path   BASELINE config 3's overlay and churn at full width:
                ``pastry_ini`` (Pastry at bitsPerDigit 4, 16 leaves,
                semi-recursive with per-hop ACKs; KBRTest one-way at
                0.2 s; ParetoChurn with lifetime and dead-time means
                1,000 s) at 10,000 target nodes (30,000 slots; cut from
                BASELINE's 50,000) with the main path's EngineParams on
                the kernels, warmed to 25 s, a measured 5 s window: alive
                nodes, delivery, hop mean and histogram, dropped routes,
                overflow, wall and device ms per tick, idle share and
                launches (``pastry_profile``, 1 more tick), host syncs
                in a tick (one more tick with every sync an error), peak
                memory.  Gate: no overflow, delivery within 0.1 of the
                port's on the CPU at N=1,000 in the same window
                (``PASTRY_REFERENCE``, scripts/torch_pareto_health.py
                --scenario pastry), every dense kernel launched;
  pastry_identity  5 ticks from ``pastry_path``'s state at its warm-up,
                kernels against the scatter inbox and plain allocation:
                every leaf equal;
  koorde_reference, broose_reference  each overlay + KBRTest (one-way
                and RPC tests every 1 s) under lifetime churn at 16
                slots, iterative, semi-recursive with per-hop ACKs and on
                the sparse tick (Broose with a 2 s joinDelay and a 5 s
                state deadline), 64 and 96 ticks on the card (kernels; in
                a child process, ``db_card_half``, beside
                ``service_reference`` and ``ini_reference``) and on the CPU
                (torch ops, held leaf-exact to the JAX package by
                tests/test_torch_koorde.py and test_torch_broose.py):
                integer leaves equal, float leaves within 1e-12 relative;
                deliveries in every run; all four kernels launched;
  koorde_path, broose_path  Koorde or Broose + KBRTest in the Chord
                path's scenario (``db_sim``: N=10,000, NoChurn over a 20 s
                ramp, test interval 0.2 s, each overlay's defaults at
                160-bit keys) on the kernels, in a child process
                (``db_lane``, with the two identities and profiles) that
                runs from ``service_path`` to ``cli_path``, beside the
                parent's phases that measure no time, warmed to ``DB_WARM_S``
                (Koorde 25 s; Broose where its join machine has settled),
                a measured 5 s window: delivery, hop mean and histogram,
                wrong-node deliveries and their share, failed lookups,
                overflow, wall and device ms, idle share and launches per
                tick (``*_profile``, 1 more tick), host syncs in a tick
                (one more tick with every sync an error), peak memory; the
                share of READY Koorde nodes with a de Bruijn pointer, the
                count of Broose nodes in each join state.  Gate: no
                overflow, delivery within 0.1 of the reference's at
                N=1,000 in the same window (``DB_REFERENCE``), the
                wrong-node share under 3 times the reference's plus
                0.0005 (``DB_WRONG_K``, ``DB_WRONG_FLOOR``), every dense
                kernel launched;
  koorde_identity, broose_identity  5 ticks from each path's warmed
                state, kernels against the scatter inbox and plain
                allocation: every leaf equal;
  epichord_reference  EpiChord + KBRTest (tests/test_torch_epichord.py's
                configuration: 64-bit keys, EpiChord's parameters as
                ``EPI_FAST`` sets them) under lifetime churn at 16 slots,
                iterative, semi-recursive and on the sparse tick, 64
                ticks, card (kernels, in a child process beside
                ``service_reference``) against CPU (torch ops): integer
                leaves equal, float leaves within 1e-12 relative;
                deliveries in every run; all four kernels launched;
  inet_reference  a reduced KademliaInet stack (``INET_INI``: verify.ini's
                module set, InetUnderlay, Kademlia + DHT + DHTTestApp
                under LifetimeChurn, at 16 slots, lifetimeMean 20 s,
                64-bit keys, 6 access routers) built from an ini by
                ``config/scenario.py``, and Chord +
                KBRTest over the ``"rease"`` topology, at 16 slots for 72
                ticks, card against CPU as above (tests/test_torch_inet.py
                holds both leaf-exact to the JAX package); puts, gets and
                deliveries; both dense kernels launched;
  epichord_path, inet_path  EpiChord + KBRTest in the de Bruijn paths'
                scenario (``db_sim``, EpiChord's defaults: a cache of 64,
                the merge-mode lookup) warmed to ``DB_WARM_S``, and the
                main path over InetUnderlay (16 access routers) warmed to
                25 s, each with a measured 5 s window, in a second child
                process (``db_lane`` of ``LANES["epichord"]``) beside the
                first: the de Bruijn paths' numbers, EpiChord's READY
                share, live cache entries per READY node and slice
                lookups, inet's latency mean beside the main path's.
                Gate: no overflow, delivery within 0.1 of the
                reference's at N=1,000 in the same window
                (``DB_REFERENCE``), the wrong-node share under
                ``DB_WRONG_K`` times the reference's plus
                ``DB_WRONG_FLOOR``, every dense kernel launched, 0 host
                syncs in one more tick;
  epichord_identity, inet_identity  5 ticks from each path's warmed
                state, kernels against scatter: every leaf equal;
  epichord_fast_identity  ``epichord_path``'s scenario at N=10,000 with
                ``EPI_FAST``'s timers (the slice check and cache expiry
                are first due after 80 s and 120 s at the defaults,
                past the path's window), warmed to 10 s on the kernels,
                then 10 ticks with the kernels and with scatter: every
                leaf equal, slice lookups started and cache entries
                expired in those ticks (both counted from the states);
  gia_reference GIA with ``GIA_FAST`` (small degree bounds, short timers)
                dense under NoChurn at 16 nodes and sparse under
                LifetimeChurn at 16 slots, 120 ticks on the card (kernels,
                in a child process beside ``service_reference``) and on
                the CPU (torch ops, held leaf-exact to the JAX package by
                tests/test_torch_gia.py): integer leaves equal, float
                leaves within 1e-12 relative; searches in both runs; all
                four kernels launched;
  vast_reference  Vast and Quon at VastParams()'s defaults, 16 nodes
                joining every 0.5 s (tests/test_vast.py's and
                test_quon.py's), dense under NoChurn and sparse under
                LifetimeChurn (16 slots), 160 ticks, card against CPU as
                above (tests/test_torch_vast.py holds them leaf-exact to
                the JAX package); position updates in every run; all four
                kernels launched;
  gia_path      BASELINE config 4 at full width: GIA (GiaParams()'s
                defaults, 160-bit keys) at 100,000 nodes under NoChurn
                over a 20 s ramp, the main path's engine on the kernels
                (P = 800,000, Q = 3,200,000), warmed to 40 s, a measured
                10 s window, in a third child process (``db_lane`` of
                ``LANES["gia"]``) beside the other two: searches,
                successes, timeouts, query drops, hop and latency means,
                the READY share, mean degree, satisfaction and tokens of
                READY nodes, wall and device ms, idle share and launches
                per tick (``gia_profile``, 1 more tick, once the other
                lanes are in), host syncs in one more tick (every sync an
                error), peak memory.  Gate: no overflow, READY share >=
                0.99, mean degree >= minNeighbors, searches and
                successes > 0, the success ratio at most (maxHopCount +
                1)(maxNeighbors + 1)/(READY nodes - 1) (a walk visits at
                most 21 nodes, each answering for its own key and 10
                neighbors'), the hop mean at most maxHopCount + 1, both
                dense kernels launched;
  gia_identity  5 ticks from ``gia_path``'s warmed state, kernels against
                the scatter inbox and plain allocation: every leaf equal;
  gia_timing    ``timing`` for the dense kernels on the inputs of one
                more GIA tick (N = 100,000, P = 800,000, Q = 3,200,000),
                in the lane after ``gia_profile``;
  vast_identity Vast and Quon at 10,000 nodes (``game_sim``: the GIA
                path's scenario and engine) warmed to 10 s on the
                kernels, then 5 ticks with the kernels and with scatter:
                every leaf equal, and JOIN, MOVE, HINT and HELLO messages
                due inside those ticks (counted from the pools), in GIA's
                lane;
  alm_reference NICE, PubSubMMOG, NTree over Chord and MyOverlay with
                MyApp in tests/test_torch_nice.py's, test_torch_pubsub.py's
                and test_torch_ntree.py's configurations (16 nodes, 4
                inbox slots), dense under NoChurn and sparse under
                LifetimeChurn, 120-150 ticks (``ALM_REF``), card against
                CPU as above (those files hold them leaf-exact to the JAX
                package); deliveries in every run; all four kernels
                launched;
  nice_path     NICE (NiceParams()'s defaults: k = 3, 4 layers; ALMTest
                publishing from every node every 20 s into the whole
                group) at 1,000 nodes (the 4-layer hierarchy holds about
                1,250) under NoChurn over a 10 s ramp, window 0.05 s, 16
                inbox and 64 outbox slots, pool factor
                ``NICE_POOL_FACTOR``, on the kernels, warmed to 80 s
                (every node joined), a measured 2 s window, in a fourth
                child process
                (``db_lane`` of ``LANES["alm"]``): multicast deliveries
                per wall second, coverage (deliveries over publishes x
                (READY - 1)), the duplicate share, the READY share, the
                mean layer count of publishers, splits, merges and
                evictions, wall and device ms, idle share and launches
                per tick (``nice_profile``, 1 more tick), host syncs in
                one more tick (every sync an error), peak memory.  Gate:
                no overflow, READY share >= 0.99, publishes > 0, coverage
                at least the N=1,000 reference's (``NICE_REFERENCE``)
                minus ``NICE_BAR``, both dense kernels launched;
  alm_identity  PubSubMMOG and MyOverlay (``game_sim``) and NTree over
                Chord (``ntree_sim``, the Chord path's scenario) at
                10,000 nodes and NICE at 1,000 (``nice_sim``), each
                warmed to 10 s on the kernels, then 5 ticks with the
                kernels and with scatter: every leaf equal, the message
                kinds due inside those ticks printed and the ones each
                overlay's join and upkeep send required, then one more
                tick with every host sync an error, in EpiChord's lane
                (the first lane to finish);
  app_reference tests/test_torch_scribe.py's and test_torch_stack.py's
                runs at 16 nodes (the TierStack of Scribe, P2PNS and
                BroadcastTestApp over Chord on the dense and the sparse
                tick, SimMud over Chord, TierStack(KBRTest, DHT) over
                Kademlia, and the KBRTest whose Common-API forward()
                vetoes some routed hops over Chord semi-recursive, alone
                and in a stack) for 80-120 ticks on the card (kernels) and
                on the CPU (torch ops, held leaf-exact to the JAX package
                by those files): integer leaves equal, float leaves within
                1e-12 relative; app traffic in every run; all four kernels
                launched;
  scribe_path   Scribe with ALMTest (ScribeParams()'s defaults: 4 groups,
                4 children, a publish every 30 s, TTL 12) over the Chord
                path's scenario at 10,000 nodes on the kernels: warm-up to
                35 s, a measured 5 s window; multicast deliveries per wall
                second, receipts per publish, the coverage (the window's
                receipts over its publishes times the READY members of
                each publisher's group), hops, latency, redirects, peak
                memory; the gate: READY >= 0.99, every group rooted,
                publishes and receipts, no overflow, receipts per publish
                at least ``SCRIBE_SHARE`` of the N=1,000 reference's
                (``SCRIBE_REFERENCE``), every dense kernel
                launched; then one tick with every host sync an error and
                ``scribe_profile``, in a fifth lane;
  app_identity  SimMud, P2PNS, BroadcastTestApp and TierStack(KBRTest,
                DHT) over the Chord path's scenario at 10,000 nodes, each
                warmed to 8 s on the kernels, then 5 ticks with the
                kernels and with scatter: every leaf equal, each app's
                message kinds due inside those ticks, one more tick with
                every host sync an error, in the fifth lane;
  kernels       one line listing the four ported kernels (``ms`` is
                ``device_ms``; ``alloc_dest`` also carries its sparse-path
                numbers as ``sparse_*`` fields, ``inbox_select_gather``
                its gather step's as ``gather_*`` fields; each kernel's
                launches on the Chord paths as ``chord_launches`` and
                ``chord_sparse_launches``, on the DHT paths as
                ``dht_launches`` and ``dht_sparse_launches``, on the
                campaign paths as ``campaign_launches`` and
                ``campaign_sparse_launches``, on the service, ingest and
                service reference runs as ``service_launches``,
                ``ingest_launches`` (``alloc_dest``'s inject call site
                alone as ``ingest_inject_launches``) and
                ``service_reference_launches``, on the ini paths as
                ``ini_reference_launches``, ``cli_launches``,
                ``pareto_launches`` and ``trace_launches``, on the
                Pastry runs as ``pastry_launches`` and
                ``pastry_reference_launches``, on Koorde's and Broose's
                as ``koorde_launches``, ``broose_launches``,
                ``koorde_reference_launches`` and
                ``broose_reference_launches``, on EpiChord's and inet's
                as ``epichord_launches``, ``inet_launches``,
                ``epichord_reference_launches`` and
                ``inet_reference_launches``, on GIA's and the game
                overlays' as ``gia_launches``, ``gia_reference_launches``
                and ``vast_reference_launches``, on NICE's and the ALM
                references' as ``nice_launches`` and
                ``alm_reference_launches``, on Scribe's and the app
                references' as ``scribe_launches`` and
                ``app_reference_launches``; the dense
                kernels' times at the DHT path's inputs as ``dht_*``
                fields, at the Pareto path's as ``pareto_*`` fields and
                at GIA's as ``gia_*`` fields);
then the nvidia-smi line and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# a torch.profiler session leaves CUPTI subscribed unless it is torn down,
# and every later tick then runs 22-27% slower on the host
# (scripts/torch_profile_aftereffect.py); the profile phases would slow
# every phase after them.  Set before torch is imported, and inherited
# by the helper and child processes.
os.environ.setdefault("TEARDOWN_CUPTI", "1")

N_MAIN = 10_000
TGT_SPARSE = 32_768          # 65,536 lifetime-churn slots
ACT_SPARSE = 0.01            # KBRTest test interval = window / activity
R = 16
POOL_FACTOR = 8
MOUT = 32
SEED = 1
# the main and Chord paths' warm-up, cut from 45 s (WARM_S_UNCUT) to keep
# the script inside its time with the ini and Pastry phases; the join
# ramp ends at 20 s.  The sparse path (1% activity) stays at 30 s: at
# 25 s its delivery is 0.908 (the gate's 0.95 needs more converged
# tables)
WARM_S = 25.0
SPARSE_WARM_S = 30.0
WARM_S_UNCUT = 45.0
# the measured window: the main and Chord paths' cut from 10 s
# (MEASURE_S_UNCUT) for the Pastry phases; the DHT path keeps 10 s, the
# width of its reference window, and the sparse path too (its 1% of
# nodes test every 20 s: over 30-35 s it delivered 0.941, under the
# gate's 0.95, as lookups still in flight at the window's end count as
# sent)
MEASURE_S = 5.0
MEASURE_S_UNCUT = 10.0
CHUNK = 25

KERNELS = {
    "inbox_select_gather": {
        "source": "oversim_tpu_torch/csrc/inbox.cu",
        "replaces": "oversim_tpu/kernels/inbox.py:53 (_inbox_kernel, "
                    "gather=True; pallas_call at :157)"},
    "alloc_dest": {
        "source": "oversim_tpu_torch/csrc/outbox.cu",
        "replaces": "oversim_tpu/kernels/outbox.py:34 (_dest_kernel; "
                    "pallas_call at :80)"},
    "inbox_select": {
        "source": "oversim_tpu_torch/csrc/inbox.cu",
        "replaces": "oversim_tpu/kernels/inbox.py:53 (_inbox_kernel, "
                    "gather=False via fused_select :203; pallas_call at "
                    ":157)"},
    "compact_indices": {
        "source": "oversim_tpu_torch/csrc/compact.cu",
        "replaces": "oversim_tpu/kernels/outbox.py:108 (_compact_kernel; "
                    "pallas_call at :140)"},
}
# the DHT path: 10,000 target nodes (20,000 lifetime-churn slots), warmed
# to verify.ini's 100 s transition, then the measured window
DHT_TARGET = 10_000
DHT_WARM_S = 100.0
# the reference's DHT success ratios at N=1,000 in the 100-110 s window
# (scripts/torch_pareto_health.py --scenario dht: the JAX package and
# the port on the CPU, normal draws off, equal in every window: 306 of
# 322 puts and 19 of 164 gets succeeded); the card's ratios must lie
# within DHT_BAR of them
DHT_REFERENCE = {"put_success_ratio": 306 / 322,
                 "get_success_ratio": 19 / 164}
DHT_BAR = 0.1
# the campaign path: two seed replicas at each of verify.ini's and the
# reference's default lifetime mean (S = 4), 10,000 target nodes (20,000
# slots) each, telemetry every 5 ticks into a ring of 24 (cut from 32
# with the warm-up, so that the ring still wraps in the run's 150 ticks)
CAMP_TARGET = 10_000
CAMP_REPLICAS = 2
CAMP_SEED = 7
CAMP_SWEEP = (("churn.lifetimeMean", (1000.0, 10000.0)),)
CAMP_TEL = (5, 24)
CAMP_TEL_UNCUT = 32
# the campaign path's warm-up and window, cut from 45 and 10 s (to 40 s
# for the service phases, to 30 s for the ini phases, to 25 s for the
# Pastry phases)
CAMP_WARM_S = 25.0
CAMP_MEASURE_S = 5.0
# the service path: windows of 1 simulated s (5 ticks of 0.2 s, one
# chunk each) from the main path's state at WARM_S, a checkpoint every 2
# windows; the child process is killed once its checkpoint says 4
SVC_WINDOWS = 8
SVC_KILL_AT = 4
SVC_EVERY = 2
SVC_WINDOW_S = 1.0
SVC_CHUNK = 5
# the ingest path: requests per window (8 x 2,000 to uniform live slots,
# a burst of two per node, 4 quiet windows), then the gateway's sockets
INGEST_WARM_S = 25.0
INGEST_PLAN = (2000,) * 8 + (2 * N_MAIN,) + (0,) * 4
INGEST_TRANSFORM = 5
# every frame goes to the gateway node, whose inbox takes R a tick: 40
# frames a window leave room for its Kademlia traffic in 5 ticks
GW_WINDOWS = 8
GW_UDP = (4, 8)       # (client sockets, datagrams each per window)
GW_TCP = (4, 2)       # (connections, frames each per window)
GW_QUIET_MAX = 12     # windows without frames, until every frame is answered
# service_reference: tests/test_torch_service_resume.py's windows
SVC_REF = {"windows": 4, "window_s": 1.0, "chunk": 10, "every": 2}
# the ini front end: ini texts and the trace are written under build/
INI_DIR = os.path.join(HERE, "build", "chip_ini")
KAD_INI = '**.overlayType = "oversim.overlay.kademlia.KademliaModules"\n'
KBR_INI = ('**.tier1Type = "oversim.applications.kbrtestapp.'
           'KBRTestAppModules"\n**.tier1*.kbrTestApp.testMsgInterval = 0.2s\n')
DHT_INI = ('**.tier1Type = "oversim.applications.dht.DHTModules"\n'
           '**.tier2Type = "oversim.tier2.dhttestapp.DHTTestAppModules"\n')
# cli_path: the main path's ini with the ini's own engine defaults
# (window 0.01 s, 8 inbox / 16 outbox slots), run to CLI_UNTIL_S (whole
# 256-tick chunks, so about 2.6 simulated s); the child runs at CLI_CHILD_N
CLI_UNTIL_S = 2.5
CLI_CHILD_N = 1_000
CLI_CHILD_UNTIL_S = 1.0      # cut from 2 s for the Pastry phases
# pareto_path: BASELINE config 3's churn (ParetoChurn, lifetime and dead
# time means 1,000 s) at 10,000 target nodes (30,000 slots), warmed to
# 25 s, a measured 5 s window
PARETO_TARGET = 10_000
PARETO_WARM_S = 25.0
PARETO_MEASURE_S = 5.0
# the reference's KBRTest delivery and population in the 25-30 s window
# at N=1,000 (scripts/torch_pareto_health.py: both packages on the CPU,
# normal draws off, equal: 18,203 of 24,493 delivered, 1,004 alive)
PARETO_REFERENCE = {"delivery": 18203 / 24493, "alive": 1004, "n": 1_000,
                    "window_s": [PARETO_WARM_S,
                                 PARETO_WARM_S + PARETO_MEASURE_S]}
PARETO_BAR = 0.1
# trace_path: a dht.trace-format file from numpy seed 1 — 10,000 JOINs
# over 20 s, 1,000 LEAVEs in 30-40 s, 20,000 PUTs and 20,000 GETs on
# 5,000 keys in 21-37 s (only from nodes that stay), types 0 and 1 split
# from 25 to 30 s; Kademlia + DHT run to 45 s
TRACE_NODES = 10_000
TRACE_LEAVES = 1_000
TRACE_OPS = 20_000
TRACE_KEYS = 5_000
TRACE_PART = (25.0, 30.0)
TRACE_UNTIL_S = 45.0
# pastry_path: BASELINE config 3's overlay and churn — Pastry at the
# reference's widths (bitsPerDigit 4, 16 leaves, 16 rows, semi-recursive
# with per-hop ACKs) under pareto_path's ParetoChurn at 10,000 target
# nodes (30,000 slots), warmed to 25 s, a measured 5 s window.  Depth
# cut: BASELINE config 3 runs 50,000 nodes (150,000 slots)
PASTRY_INI = ('**.overlayType = "oversim.overlay.pastry.PastryModules"\n'
              '**.overlay.pastry.bitsPerDigit = 4\n'
              '**.overlay.pastry.numberOfLeaves = 16\n'
              '**.routingType = "semi-recursive"\n')
PASTRY_TARGET = 10_000
PASTRY_FULL_TARGET = 50_000
PASTRY_WARM_S = 25.0
PASTRY_MEASURE_S = 5.0
# the port's Pastry numbers on the CPU in the 25-30 s window at N=1,000
# (scripts/torch_pareto_health.py --scenario pastry --side torch, normal
# draws off: 24,422 of 24,470 delivered, hop mean 1.938, 4 routes
# dropped, 1,004 alive).  The JAX package's side does not compile at 16
# inbox slots and 160-bit keys within 27 GB of host memory; at N=300 and
# 4 inbox slots both packages print the same windows (PERF.md §2), and
# the port's Pastry tick is leaf-exact with the JAX package's in
# tests/test_torch_pastry.py
PASTRY_REFERENCE = {"delivery": 24422 / 24470, "hop_mean": 1.9380886,
                    "route_dropped": 4, "alive": 1004, "n": 1_000,
                    "window_s": [PASTRY_WARM_S,
                                 PASTRY_WARM_S + PASTRY_MEASURE_S]}
PASTRY_BAR = 0.1
# the de Bruijn paths: Koorde and Broose + KBRTest at the Chord path's
# shape (chord_sim: NoChurn over a 20 s ramp, test interval 0.2 s,
# window 0.2 s, 16 inbox and 32 outbox slots) and their overlays'
# default parameters; Broose's join machine (INIT -> RSET -> BSET ->
# READY, paced bucket pulls) has settled by 30 s (no joins in 30-35 s at
# N=1,000, delivery 0.983 at N=10,000: scripts/torch_db_windows.py)
DB_TARGET = 10_000
DB_WARM_S = {"koorde": 25.0, "broose": 30.0}
DB_MEASURE_S = 5.0
# the reference's KBRTest numbers in the same window at N=1,000 on the
# CPU (scripts/torch_pareto_health.py --scenario koorde|broose, normal
# draws off; the JAX package and the port print the same windows):
# delivered of sent, and the wrong-node deliveries
DB_REFERENCE = {
    "koorde": {"delivered": 10807, "sent": 24153, "wrong_node": 24,
               "n": 1_000, "window_s": [25.0, 30.0]},
    "broose": {"delivered": 24405, "sent": 25000, "wrong_node": 5,
               "n": 1_000, "window_s": [30.0, 35.0]}}
DB_BAR = 0.1
# neither overlay stops delivering to wrong nodes, the reference
# included: the window's wrong-node share of deliveries must stay under
# DB_WRONG_K times the reference's plus DB_WRONG_FLOOR.  At N=10,000
# (scripts/torch_db_windows.py) the share was 0.86-4.9 times N=1,000's
# in the same window (Koorde 20-25 s 1.60, 25-30 s 2.37; Broose 25-30 s
# 0.86, 30-35 s 4.45, 35-40 s 4.9), the larger ratios where N=1,000 had
# 3-5 wrong deliveries; the floor is 12 of N=1,000's 25,000 a window
DB_WRONG_K = 3.0
DB_WRONG_FLOOR = 0.0005
# EpiChord's path: db_sim's scenario with EpiChord's defaults (a cache of
# 64, the merge-mode lookup), warmed to 30 s: at N=1,000 the reference
# delivers 0.5865 in 20-25 s and 0.7581-0.7627 in each 5 s window from 25
# to 45 s (scripts/torch_pareto_health.py --scenario epichord, both
# packages equal on the CPU; the readings in PERF.md §6); its wrong-node
# deliveries are 33, 4, then 0, 1, 0
DB_WARM_S["epichord"] = 30.0
DB_REFERENCE["epichord"] = {"delivered": 19068, "sent": 25000,
                            "wrong_node": 0, "n": 1_000,
                            "window_s": [30.0, 35.0]}
# inet_path: the main path (bench_sim) over InetUnderlay with
# config/scenario.py's default of 16 access routers; its N=1,000
# reference in the same window (scripts/torch_pareto_health.py
# --scenario inet, both packages equal): delivery 0.9984, mean one-way
# latency 0.952 s, 22 wrong-node deliveries (Kademlia's, as on the main
# path)
INET_ROUTERS = 16
DB_WARM_S["inet"] = WARM_S
DB_REFERENCE["inet"] = {"delivered": 24960, "sent": 25000,
                        "wrong_node": 22, "n": 1_000,
                        "window_s": [WARM_S, WARM_S + MEASURE_S]}
# the reference runs (16 slots) of each lane overlay: lifetime churn for
# the de Bruijn overlays and EpiChord (iterative, semi-recursive, sparse;
# tests/test_torch_koorde.py, test_torch_broose.py, test_torch_epichord.py
# hold them leaf-exact to the JAX package), and for the router topology
# a reduced KademliaInet stack built from an ini (INET_INI) and Chord +
# KBRTest over "rease" (tests/test_torch_inet.py)
DB_REF = {"koorde": ("koorde_iter", "koorde_semi", "koorde_sparse"),
          "broose": ("broose_iter", "broose_semi", "broose_sparse"),
          "epichord": ("epichord_iter", "epichord_semi", "epichord_sparse"),
          "inet": ("inet_kad", "inet_chord")}
# EpiChord's eight ini parameters off their defaults, shortened so that
# stabilize, cache expiry and the slice check all run inside the
# reference runs (tests/test_torch_epichord.py uses them too), and those
# runs' churn: LifetimeChurn at its 15 s graceful-leave default, as
# config/scenario.py sets it from an ini
EPI_FAST = dict(succ_size=3, join_delay=2.0, stabilize_delay=2.0,
                cache_flush_delay=1.0, cache_check_mult=2, cache_ttl=4.0,
                nodes_per_slice=3, redundant_nodes=2)
# epichord_fast_identity: EPI_FAST's timers on epichord_path's scenario
# (EpiChord's other parameters at their defaults), so that the slice
# check and cache expiry, first due after 80 s and 120 s at the
# defaults, run at full width: warmed to EPI_FAST_WARM_S, then
# EPI_FAST_TICKS ticks
EPI_FAST_TIMERS = ("join_delay", "stabilize_delay", "cache_flush_delay",
                   "cache_check_mult", "cache_ttl")
EPI_FAST_WARM_S = 10.0
EPI_FAST_TICKS = 10
EPI_LIFETIME_S = 20.0
# a reduced KademliaInet stack: verify.ini's module set (InetUnderlay,
# Kademlia + DHT + DHTTestApp under LifetimeChurn) at 8 target nodes
# (16 slots), lifetimeMean 20 s, 64-bit keys and 6 access routers, where
# verify.ini's shared scenario has 100 nodes, lifetimeMean 1,000 s and
# 160-bit keys
INET_INI = """
[General]
**.targetOverlayTerminalNum = 8
**.initPhaseCreationInterval = 0.1s
**.churnGeneratorTypes = "oversim.common.LifetimeChurn"
**.lifetimeMean = 20s

[Config KademliaInet]
network = oversim.underlay.inetunderlay.InetUnderlayNetwork
**.overlayType = "oversim.overlay.kademlia.KademliaModules"
**.tier1Type = "oversim.applications.dht.DHTModules"
**.tier2Type = "oversim.tier2.dhttestapp.DHTTestAppModules"
**.keyLength = 64
**.accessRouterNum = 6
**.tier2*.dhtTestApp.testInterval = 1s
"""
# gia_path: BASELINE config 4 (GIA, unstructured, 100,000 nodes,
# random-walk search) at GiaParams()'s defaults (default.ini's gia
# namespace) and 160-bit keys: NoChurn over a 20 s ramp, the main path's
# engine widths, warmed to 40 s, a measured 10 s window (the first
# searches fire up to 60 s after each join, so the window is past the
# ramp's settling and inside the first search round)
GIA_TARGET = 100_000
GIA_WARM_S = 40.0
GIA_MEASURE_S = 10.0
# gia_reference: GIA's degree bounds and timers shortened so that every
# branch fires inside the reference runs (tests/test_torch_gia.py holds
# the same parameters leaf-exact to the JAX package), dense under
# NoChurn at 16 nodes and sparse under LifetimeChurn at 16 slots
GIA_FAST = dict(min_neighbors=2, max_neighbors=3, adapt_interval=1.0,
                token_interval=0.5, max_tokens=2, search_interval=2.0,
                search_ttl=4, search_timeout=1.5, join_delay=1.0,
                token_wait=0.3, token_wait_max=2)
GAME_REF = {"gia": ("gia_dense", "gia_sparse"),
            "vast": ("vast_dense", "vast_sparse", "quon_dense",
                     "quon_sparse")}
# vast_identity: Vast and Quon (VastParams()'s defaults) at 10,000 nodes
# over the 20 s ramp, warmed to VAST_WARM_S (joins still arriving, every
# early node moving), then VAST_TICKS ticks kernels against scatter
VAST_TARGET = 10_000
VAST_WARM_S = 10.0
VAST_TICKS = 5
# nice_path: NICE at NiceParams()'s defaults (k = 3, 4 layers) with
# ALMTest publishing from every node every 20 s to the whole group, at
# NICE_TARGET nodes over a NICE_RAMP_S NoChurn ramp, warmed to
# NICE_WARM_S, a NICE_MEASURE_S window.  The 4-layer hierarchy holds
# about 1,250 nodes: at 2,048 its READY count stops at 1,253 (the port
# on the CPU, PERF.md §6, "NICE's size"), so the path runs 1,000,
# which join by about 80 s (the joiners queue at the rendezvous point,
# whose inbox takes R a tick).  The window is tests/test_nice.py's
# 0.05 s (at 0.2 s the rendezvous point's inbox falls behind for good),
# with tests/test_nice.py's 64 outbox slots (a top leader heartbeats and
# forwards into up to 4 layers of 10 members) and a pool factor of 32,
# with which nothing overflows
NICE_TARGET = 1_000
NICE_RAMP_S = 10.0
NICE_WINDOW = 0.05
NICE_WARM_S = 80.0
NICE_MEASURE_S = 2.0
NICE_MOUT = 64
NICE_POOL_FACTOR = 32
# the same scenario's window 80-82 s, both packages equal on the CPU
# with the normal draws off (scripts/torch_pareto_health.py --scenario
# nice): nice_path's coverage gate is this minus NICE_BAR
NICE_REFERENCE = {"coverage": 8802 / (65 * 920), "n": 1_000,
                  "window_s": [80.0, 82.0], "ready_share": 0.921}
NICE_BAR = 0.1
# alm_reference: NICE, PubSubMMOG, NTree over Chord and MyOverlay at 16
# nodes, tests/test_torch_nice.py's, test_torch_pubsub.py's and
# test_torch_ntree.py's configurations, dense under NoChurn and sparse
# under LifetimeChurn: label -> ticks
ALM_REF = {"nice_dense": 150, "nice_sparse": 150, "pubsub_dense": 120,
           "pubsub_sparse": 120, "ntree_dense": 120, "ntree_sparse": 120,
           "my_dense": 120, "my_sparse": 120}
# alm_identity: PubSubMMOG and MyOverlay (their defaults, game_sim) and
# NTree over Chord (ntree_sim) at 10,000 nodes, NICE at NICE_TARGET
# (nice_sim), each warmed to ALM_WARM_S, then ALM_TICKS ticks kernels
# against scatter
ALM_TARGET = 10_000
ALM_WARM_S = 10.0
ALM_TICKS = 5
# scribe_path: Scribe with ALMTest at ScribeParams()'s defaults (4
# groups, 4 children, a publish every 30 s, TTL 12) over the Chord
# path's scenario (chord_sim: NoChurn over a 20 s ramp, window 0.2 s)
# at SCRIBE_TARGET nodes, warmed to SCRIBE_WARM_S (READY >= 0.99 and
# every group rooted), a SCRIBE_MEASURE_S window
SCRIBE_TARGET = 10_000
SCRIBE_WARM_S = 35.0
SCRIBE_MEASURE_S = 5.0
# the same scenario's window at 1,000 nodes, both packages equal on the
# CPU with the normal draws off (scripts/torch_pareto_health.py
# --scenario scribe): 172 publishes, 3,244 receipts.  Receipts per
# publish, not coverage, is what holds across sizes: each group's tree
# reaches about the same number of members at 1,000 and 10,000 nodes
# (18.9 and 16.5 receipts a publish; NVIDIA H100 80GB HBM3, 700 W), so
# coverage falls as 1 / the group's size.  scribe_path's gate is
# SCRIBE_SHARE of the reference's receipts per publish.
SCRIBE_REFERENCE = {"published": 172, "received": 3244, "n": 1_000,
                    "window_s": [35.0, 40.0], "ready_share": 0.999}
SCRIBE_SHARE = 0.75
# app_reference: tests/test_torch_scribe.py's and test_torch_stack.py's
# runs at 16 nodes (the stack of Scribe, P2PNS and BroadcastTestApp over
# Chord dense and sparse, SimMud, KBRTest + DHT over Kademlia, the
# vetoing KBRTest over Chord semi-recursive alone and in a stack):
# label -> ticks
APP_REF = {"stack_dense": 120, "stack_sparse": 120, "simmud": 120,
           "kad_stack": 120, "veto_chord": 80, "veto_stack": 80}
# app_identity: SimMud, P2PNS, BroadcastTestApp and TierStack(KBRTest,
# DHT) over the Chord path's scenario at APP_TARGET nodes, warmed to
# APP_WARM_S, then APP_TICKS ticks kernels against scatter
APP_TARGET = 10_000
APP_WARM_S = 8.0
APP_TICKS = 5
DENSE_KERNELS = ("inbox_select_gather", "alloc_dest")
SPARSE_KERNELS = ("inbox_select", "compact_indices", "alloc_dest")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet


T_START = time.perf_counter()
# helper processes running the reference phases' CPU halves, in order
HELPERS = 2


def emit(obj):
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "at_s": round(time.perf_counter() - T_START,
                                           1)}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# -- configurations ---------------------------------------------------------

def bench_sim(n, device, inbox_impl, *, deviation=None, jitter=0.1,
              inbox=None, outbox=None, underlay="simple"):
    """bench.py's Kademlia + KBRTest configuration at ``n`` nodes (inbox
    and outbox slots default to this script's R and MOUT); ``underlay=
    "inet"`` puts it on InetUnderlay's router topology with INET_ROUTERS
    access routers (``inet_path``)."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.kademlia import KademliaLogic
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    logic = KademliaLogic(app=KbrTestApp(KbrTestParams(test_interval=0.2)),
                          lcfg=LookupConfig(slots=8, merge=True))
    cp = churn.ChurnParams(
        model="none", target_num=n, init_interval=20.0 / n,
        init_deviation=2.0 / n if deviation is None else deviation)
    ep = EngineParams(window=0.2, inbox_slots=inbox or R,
                      pool_factor=POOL_FACTOR, outbox_slots=outbox or MOUT,
                      inbox_impl=inbox_impl)
    if underlay == "inet":
        from oversim_tpu_torch.underlay import inet
        return Simulation(logic, cp, inet.InetUnderlayParams(
            routers=INET_ROUTERS, jitter=jitter), ep,
            underlay_module=inet, device=device)
    return Simulation(logic, cp, UnderlayParams(jitter=jitter), ep,
                      device=device)


def sparse_sim(target, device, inbox_impl, *, tick_impl="sparse",
               active_cap=0, life=1000.0, rejoin=False):
    """The sparse path: Kademlia + KBRTest at 1% activity under lifetime
    churn (2 * ``target`` slots); ``rejoin`` keeps a slot's nodeId across
    its rebirths (LifetimeChurn context slots)."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.kademlia import KademliaLogic
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    window = 0.2
    logic = KademliaLogic(
        app=KbrTestApp(KbrTestParams(test_interval=window / ACT_SPARSE)),
        lcfg=LookupConfig(slots=8, merge=True))
    cp = churn.ChurnParams(
        model="lifetime", target_num=target, init_interval=20.0 / target,
        init_deviation=2.0 / target, lifetime_mean=life,
        lifetime_dist="weibull", lifetime_par1=1.0, rejoin_context=rejoin)
    ep = EngineParams(window=window, inbox_slots=R, outbox_slots=MOUT,
                      pool_factor=POOL_FACTOR, inbox_impl=inbox_impl,
                      tick_impl=tick_impl, active_cap=active_cap)
    return Simulation(logic, cp, UnderlayParams(jitter=0.1), ep,
                      device=device)


def tiny_sparse_sim(device, inbox_impl):
    """tests/test_torch_sparse.py's configuration: 12 target (24 slots),
    lifetime mean 8 s, normal draws off (init_deviation = jitter = 0)."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.kademlia import KademliaLogic
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    cp = churn.ChurnParams(model="lifetime", target_num=12,
                           init_interval=0.2, init_deviation=0.0,
                           lifetime_mean=8.0, graceful_leave_delay=1.0)
    ep = EngineParams(window=0.1, inbox_slots=4, pool_factor=4,
                      inbox_impl=inbox_impl, tick_impl="sparse")
    return Simulation(
        KademliaLogic(app=KbrTestApp(KbrTestParams(test_interval=1.0))), cp,
        UnderlayParams(jitter=0.0), ep, device=device)


def chord_sim(n, device, inbox_impl, *, deviation=None, jitter=0.1,
              inbox=None, outbox=None, app=None):
    """bench.py's Chord + KBRTest configuration at ``n`` nodes (Chord's
    default: iterative replace-mode lookups with 8 slots, Vivaldi, the
    RTT cache's adaptive timeouts); inbox and outbox slots default to this
    script's R and MOUT, as on the Kademlia path.  ``app`` replaces
    KBRTest."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.chord import ChordLogic
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    logic = ChordLogic(app=app or KbrTestApp(KbrTestParams(
        test_interval=0.2)), lcfg=LookupConfig(slots=8))
    cp = churn.ChurnParams(
        model="none", target_num=n, init_interval=20.0 / n,
        init_deviation=2.0 / n if deviation is None else deviation)
    ep = EngineParams(window=0.2, inbox_slots=inbox or R,
                      pool_factor=POOL_FACTOR, outbox_slots=outbox or MOUT,
                      inbox_impl=inbox_impl)
    return Simulation(logic, cp, UnderlayParams(jitter=jitter), ep,
                      device=device)


def tiny_chord_sparse_sim(device, inbox_impl):
    """tests/test_torch_chord_sparse.py's configuration: Chord + KBRTest
    under lifetime churn at 24 slots, the sparse tick at its auto cap."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.chord import ChordLogic
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    cp = churn.ChurnParams(model="lifetime", target_num=12,
                           init_interval=0.2, init_deviation=0.0,
                           lifetime_mean=8.0, graceful_leave_delay=1.0)
    ep = EngineParams(window=0.1, inbox_slots=4, pool_factor=4,
                      inbox_impl=inbox_impl, tick_impl="sparse")
    return Simulation(
        ChordLogic(app=KbrTestApp(KbrTestParams(test_interval=1.0)),
                   lcfg=LookupConfig(slots=8)), cp,
        UnderlayParams(jitter=0.0), ep, device=device)


def db_sim(overlay, n, device, inbox_impl, *, deviation=None, jitter=0.1,
           epi_params=None):
    """``koorde_path``'s, ``broose_path``'s or ``epichord_path``'s
    simulation: ``chord_sim``'s scenario and engine with Koorde, Broose
    or EpiChord (160-bit keys, the overlay's default parameters and
    lookup configuration; ``epi_params`` replaces EpiChord's)."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    app = KbrTestApp(KbrTestParams(test_interval=0.2))
    if overlay == "koorde":
        from oversim_tpu_torch.overlay.koorde import KoordeLogic
        logic = KoordeLogic(app=app)
    elif overlay == "epichord":
        from oversim_tpu_torch.overlay.epichord import (EpiChordLogic,
                                                        EpiChordParams)
        logic = EpiChordLogic(params=epi_params or EpiChordParams(),
                              app=app)
    else:
        from oversim_tpu_torch.overlay.broose import BrooseLogic
        logic = BrooseLogic(app=app)
    cp = churn.ChurnParams(
        model="none", target_num=n, init_interval=20.0 / n,
        init_deviation=2.0 / n if deviation is None else deviation)
    ep = EngineParams(window=0.2, inbox_slots=R, pool_factor=POOL_FACTOR,
                      outbox_slots=MOUT, inbox_impl=inbox_impl)
    return Simulation(logic, cp, UnderlayParams(jitter=jitter), ep,
                      device=device)


def tiny_db_sim(label, device, inbox_impl):
    """A ``DB_REF`` run: tests/test_torch_koorde.py's and
    test_torch_broose.py's configurations (KBRTest one-way and RPC tests
    every 1 s, LifetimeChurn, normal draws off) at 8 target nodes (16
    slots): iterative, semi-recursive with per-hop ACKs, and the sparse
    tick; Broose with the tests' 2 s joinDelay and 5 s state deadline."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.common.route import RouteConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    overlay, mode = label.split("_")
    rcfg = RouteConfig(mode="semi") if mode == "semi" else None
    app = KbrTestApp(KbrTestParams(test_interval=1.0, rpc_test=True),
                     rcfg=rcfg)
    if overlay == "koorde":
        from oversim_tpu_torch.overlay.koorde import KoordeLogic
        logic = KoordeLogic(app=app, rcfg=rcfg)
    else:
        from oversim_tpu_torch.overlay.broose import BrooseLogic, BrooseParams
        logic = BrooseLogic(params=BrooseParams(
            join_delay=2.0, join_state_timeout=5.0), app=app, rcfg=rcfg)
    cp = churn.ChurnParams(model="lifetime", target_num=8,
                           init_interval=0.2, init_deviation=0.0,
                           lifetime_mean=8.0, graceful_leave_delay=1.0)
    ep = EngineParams(window=0.1, inbox_slots=4, pool_factor=4,
                      inbox_impl=inbox_impl,
                      tick_impl="sparse" if mode == "sparse" else "dense")
    return Simulation(logic, cp, UnderlayParams(jitter=0.0), ep,
                      device=device)


def tiny_epi_sim(label, device, inbox_impl):
    """An EpiChord ``DB_REF`` run: tests/test_torch_epichord.py's
    configuration (64-bit keys, ``EPI_FAST``, KBRTest one-way and RPC
    tests every 1 s, LifetimeChurn with mean ``EPI_LIFETIME_S``, normal
    draws off) at 8 target nodes (16 slots): iterative, semi-recursive
    with per-hop ACKs, and the sparse tick."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.common.route import RouteConfig
    from oversim_tpu_torch.core.keys import KeySpec
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.epichord import (EpiChordLogic,
                                                    EpiChordParams)
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    mode = label.split("_")[1]
    rcfg = RouteConfig(mode="semi") if mode == "semi" else None
    app = KbrTestApp(KbrTestParams(test_interval=1.0, rpc_test=True),
                     rcfg=rcfg)
    logic = EpiChordLogic(KeySpec(64), EpiChordParams(**EPI_FAST), app=app,
                          rcfg=rcfg)
    cp = churn.ChurnParams(model="lifetime", target_num=8,
                           init_interval=0.2, init_deviation=0.0,
                           lifetime_mean=EPI_LIFETIME_S)
    ep = EngineParams(window=0.1, inbox_slots=4, pool_factor=4,
                      inbox_impl=inbox_impl,
                      tick_impl="sparse" if mode == "sparse" else "dense")
    return Simulation(logic, cp, UnderlayParams(jitter=0.0), ep,
                      device=device)


def tiny_inet_sim(label, device, inbox_impl):
    """An inet ``DB_REF`` run (tests/test_torch_inet.py's scenarios at 16
    slots, normal draws off): ``inet_kad``, ``INET_INI``'s reduced
    KademliaInet stack built by ``config/scenario.py`` with the reference
    runs' engine (window 0.1 s, 4 inbox slots, pool factor 4);
    ``inet_chord``, Chord + KBRTest at 96-bit keys under NoChurn over
    ``"rease"`` with 8 routers."""
    import dataclasses
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.config.ini import IniFile
    from oversim_tpu_torch.config.scenario import (build_engine_params,
                                                   build_simulation)
    from oversim_tpu_torch.core.keys import KeySpec
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.chord import ChordLogic
    from oversim_tpu_torch.underlay import inet
    if label == "inet_kad":
        ini = IniFile.loads(INET_INI)
        ep = dataclasses.replace(
            build_engine_params(ini, "KademliaInet"), window=0.1,
            inbox_slots=4, pool_factor=4, inbox_impl=inbox_impl)
        return normals_off(build_simulation(ini, "KademliaInet",
                                            engine_params=ep, device=device))
    cp = churn.ChurnParams(model="none", target_num=16, init_interval=0.2,
                           init_deviation=0.0)
    ep = EngineParams(window=0.1, inbox_slots=4, pool_factor=4,
                      inbox_impl=inbox_impl)
    logic = ChordLogic(KeySpec(96), app=KbrTestApp(KbrTestParams(
        test_interval=1.0, rpc_test=True)))
    return Simulation(logic, cp, inet.InetUnderlayParams(
        topology="rease", routers=8, jitter=0.0), ep,
        underlay_module=inet, device=device)


def tiny_lane_sim(label, device, inbox_impl):
    """A ``DB_REF`` run of any lane overlay."""
    if label.startswith("epichord"):
        return tiny_epi_sim(label, device, inbox_impl)
    if label.startswith("inet"):
        return tiny_inet_sim(label, device, inbox_impl)
    return tiny_db_sim(label, device, inbox_impl)


def lane_sim(overlay, device, inbox_impl):
    """A lane path's full-width simulation."""
    if overlay == "inet":
        return bench_sim(N_MAIN, device, inbox_impl, underlay="inet")
    return db_sim(overlay, DB_TARGET, device, inbox_impl)


def game_sim(logic, n, device, inbox_impl):
    """``gia_path``'s and ``vast_identity``'s simulation: ``logic`` (GIA,
    Vast or Quon at 160-bit keys) under NoChurn over a 20 s ramp, window
    0.2 s, this script's R, MOUT and pool factor."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    cp = churn.ChurnParams(model="none", target_num=n,
                           init_interval=20.0 / n, init_deviation=2.0 / n)
    ep = EngineParams(window=0.2, inbox_slots=R, pool_factor=POOL_FACTOR,
                      outbox_slots=MOUT, inbox_impl=inbox_impl)
    return Simulation(logic, cp, UnderlayParams(jitter=0.1), ep,
                      device=device)


def game_logic(overlay):
    """``overlay``'s logic ("gia", "vast" or "quon") at its defaults."""
    from oversim_tpu_torch.overlay.gia import GiaLogic
    from oversim_tpu_torch.overlay.quon import QuonLogic
    from oversim_tpu_torch.overlay.vast import VastLogic
    return {"gia": GiaLogic, "vast": VastLogic, "quon": QuonLogic}[overlay]()


def tiny_game_sim(label, device, inbox_impl):
    """A ``GAME_REF`` run (normal draws off; the engine of
    tests/test_torch_gia.py and test_torch_vast.py: window 0.1 s, 4 inbox
    slots, pool factor 4): GIA with ``GIA_FAST``, or Vast or Quon at
    VastParams()'s defaults with tests/test_vast.py's and test_quon.py's
    16 nodes joining every 0.5 s; ``*_dense`` under NoChurn at 16 nodes,
    ``*_sparse`` under LifetimeChurn (1 s graceful leave) at 16 slots on
    the sparse tick."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.gia import GiaLogic, GiaParams
    from oversim_tpu_torch.overlay.quon import QuonLogic
    from oversim_tpu_torch.overlay.vast import VastLogic
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    overlay, impl = label.split("_")
    gia = overlay == "gia"
    interval = 0.2 if gia else 0.5
    if impl == "dense":
        cp = churn.ChurnParams(model="none", target_num=16,
                               init_interval=interval, init_deviation=0.0)
    else:
        cp = churn.ChurnParams(model="lifetime", target_num=8,
                               init_interval=interval, init_deviation=0.0,
                               lifetime_mean=8.0 if gia else 20.0,
                               graceful_leave_delay=1.0)
    if gia:
        logic = GiaLogic(params=GiaParams(**GIA_FAST))
    else:
        logic = VastLogic() if overlay == "vast" else QuonLogic()
    ep = EngineParams(window=0.1, inbox_slots=4, pool_factor=4,
                      inbox_impl=inbox_impl, tick_impl=impl)
    return Simulation(logic, cp, UnderlayParams(jitter=0.0), ep,
                      device=device)


def nice_sim(n, device, inbox_impl, *, deviation=None, jitter=0.1):
    """``nice_path``'s simulation: NICE at its defaults under NoChurn
    over a NICE_RAMP_S ramp, window NICE_WINDOW, R inbox slots,
    NICE_MOUT outbox slots, pool factor NICE_POOL_FACTOR."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.nice import NiceLogic
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    step = NICE_RAMP_S / n
    cp = churn.ChurnParams(
        model="none", target_num=n, init_interval=step,
        init_deviation=0.1 * step if deviation is None else deviation)
    ep = EngineParams(window=NICE_WINDOW, inbox_slots=R,
                      outbox_slots=NICE_MOUT, pool_factor=NICE_POOL_FACTOR,
                      inbox_impl=inbox_impl)
    return Simulation(NiceLogic(), cp, UnderlayParams(jitter=jitter), ep,
                      device=device)


def ntree_sim(n, device, inbox_impl):
    """NTree (NTreeParams()'s defaults) over the Chord path's scenario
    (``chord_sim``) in place of KBRTest, as the builder's NTreeModules."""
    from oversim_tpu_torch.apps.ntree import NTreeApp
    return chord_sim(n, device, inbox_impl, app=NTreeApp())


def alm_logic(overlay):
    """PubSubMMOG's or MyOverlay's logic (with MyApp) at its defaults."""
    from oversim_tpu_torch.overlay.myoverlay import MyOverlayLogic
    from oversim_tpu_torch.overlay.pubsubmmog import PubSubMMOGLogic
    return {"pubsub": PubSubMMOGLogic, "my": MyOverlayLogic}[overlay]()


def tiny_alm_sim(label, device, inbox_impl):
    """An ``ALM_REF`` run: tests/test_torch_nice.py's,
    test_torch_pubsub.py's and test_torch_ntree.py's configurations (16
    nodes joining every 0.5 s, 4 inbox slots, normal draws off),
    ``*_dense`` under NoChurn, ``*_sparse`` under LifetimeChurn (mean
    20 s, 1 s graceful leave) on the sparse tick."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.dummy import MyApp, MyAppParams
    from oversim_tpu_torch.apps.ntree import NTreeApp, NTreeParams
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.chord import ChordLogic
    from oversim_tpu_torch.overlay.myoverlay import (MyOverlayLogic,
                                                     MyOverlayParams)
    from oversim_tpu_torch.overlay.nice import NiceLogic, NiceParams
    from oversim_tpu_torch.overlay.pubsubmmog import (PubSubMMOGLogic,
                                                      PubSubParams)
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    overlay, impl = label.split("_")
    if impl == "dense":
        cp = churn.ChurnParams(model="none", target_num=16,
                               init_interval=0.5, init_deviation=0.0)
    else:
        cp = churn.ChurnParams(model="lifetime", target_num=16,
                               init_interval=0.5, init_deviation=0.0,
                               lifetime_mean=20.0, graceful_leave_delay=1.0)
    ep = dict(window=0.2, inbox_slots=4, pool_factor=16)
    if overlay == "nice":
        logic = NiceLogic(params=NiceParams(
            hb_interval=2.0, maint_interval=1.5, query_interval=1.0))
        ep.update(outbox_slots=64)
    elif overlay == "pubsub":
        logic = PubSubMMOGLogic(params=PubSubParams(field=400.0,
                                                    max_children=3))
        ep.update(window=0.1, outbox_slots=64, pool_factor=8)
    elif overlay == "ntree":
        logic = ChordLogic(app=NTreeApp(NTreeParams(max_children=3)))
    else:
        logic = MyOverlayLogic(params=MyOverlayParams(
            join_delay=2.0, hello_interval=4.0),
            app=MyApp(MyAppParams(interval=2.0)))
    return Simulation(logic, cp, UnderlayParams(jitter=0.0), EngineParams(
        inbox_impl=inbox_impl, tick_impl=impl, **ep), device=device)


def scribe_sim(n, device, inbox_impl, *, deviation=None, jitter=0.1):
    """``scribe_path``'s simulation: ScribeApp() over ``chord_sim``."""
    from oversim_tpu_torch.apps.scribe import ScribeApp
    return chord_sim(n, device, inbox_impl, deviation=deviation,
                     jitter=jitter, app=ScribeApp())


def app_sim(name, n, device, inbox_impl):
    """An ``app_identity`` case over ``chord_sim``: SimMud, P2PNS or
    BroadcastTestApp at its defaults, or TierStack(KBRTest, DHT) (tests
    every 2 s)."""
    from oversim_tpu_torch.apps.broadcast import BroadcastTestApp
    from oversim_tpu_torch.apps.dht import DhtApp, DhtParams
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.apps.p2pns import P2pnsApp
    from oversim_tpu_torch.apps.simmud import SimMudApp
    from oversim_tpu_torch.apps.stack import TierStack
    app = {"simmud": SimMudApp, "broadcast": BroadcastTestApp,
           "p2pns": lambda: P2pnsApp(num_slots=n),
           "stack": lambda: TierStack([
               KbrTestApp(KbrTestParams(test_interval=2.0)),
               DhtApp(DhtParams(test_interval=2.0))])}[name]()
    return chord_sim(n, device, inbox_impl, app=app)


def veto_kbr_app(rcfg):
    """tests/test_torch_stack.py's VetoKbrTestApp: KBRTest (one-way and
    routed RPC tests every 1 s) whose Common-API ``forward()`` vetoes the
    routed hops of keys whose low lane is 0 mod 4."""
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams

    class VetoKbrTestApp(KbrTestApp):
        def forward(self, app, msgs, ctx):
            return msgs.valid & (msgs.key[..., 0] % 4 == 0)

    return VetoKbrTestApp(KbrTestParams(test_interval=1.0, rpc_test=True),
                          rcfg=rcfg)


def tiny_app_sim(label, device, inbox_impl):
    """An ``APP_REF`` run: tests/test_torch_scribe.py's runs (16 nodes
    joining every 0.5 s, window 0.2 s, 4 inbox slots, pool factor 16;
    ``stack_*`` the TierStack of Scribe, P2PNS and BroadcastTestApp over
    Chord, tuned timers under NoChurn on the dense tick, the ini's
    defaults under LifetimeChurn (mean 40 s) on the sparse tick;
    ``simmud`` at its defaults) and test_torch_stack.py's (``kad_stack``:
    KBRTest + DHT over Kademlia; ``veto_*``: the vetoing KBRTest over
    Chord semi-recursive, alone and in a stack with BroadcastTestApp,
    12 target under LifetimeChurn, window 0.1 s, pool factor 4), normal
    draws off."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.broadcast import (BroadcastTestApp,
                                                  BroadcastTestParams)
    from oversim_tpu_torch.apps.dht import DhtApp, DhtParams
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.apps.p2pns import P2pnsApp, P2pnsParams
    from oversim_tpu_torch.apps.scribe import ScribeApp, ScribeParams
    from oversim_tpu_torch.apps.simmud import SimMudApp
    from oversim_tpu_torch.apps.stack import TierStack
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.common.route import RouteConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.chord import ChordLogic
    from oversim_tpu_torch.overlay.kademlia import KademliaLogic
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    nochurn = churn.ChurnParams(model="none", target_num=16,
                                init_interval=0.5, init_deviation=0.0)
    ep = dict(window=0.2, inbox_slots=4, pool_factor=16)
    if label.startswith("veto"):
        rc = RouteConfig(mode="semi")
        app = veto_kbr_app(rc)
        if label == "veto_stack":
            app = TierStack([app, BroadcastTestApp(
                BroadcastTestParams(interval=3.0))])
        logic = ChordLogic(app=app, rcfg=rc, lcfg=LookupConfig(slots=8))
        cp = churn.ChurnParams(model="lifetime", target_num=12,
                               init_interval=0.2, init_deviation=0.0,
                               lifetime_mean=8.0, graceful_leave_delay=1.0)
        ep = dict(window=0.1, inbox_slots=4, pool_factor=4)
    elif label == "kad_stack":
        logic = KademliaLogic(app=TierStack([
            KbrTestApp(KbrTestParams(test_interval=20.0)),
            DhtApp(DhtParams(test_interval=20.0, test_ttl=600.0))]))
        cp = nochurn
    elif label == "simmud":
        logic, cp = ChordLogic(app=SimMudApp()), nochurn
    else:
        if label == "stack_dense":
            cp, sp, pp, bp = nochurn, ScribeParams(
                num_groups=3, publish_interval=10.0, subscribe_refresh=8.0,
                child_timeout=20.0, children=2), P2pnsParams(
                resolve_interval=5.0, keepalive=20.0, cache_ttl=30.0,
                cache_size=2, storage_slots=4), BroadcastTestParams(
                interval=15.0)
        else:
            cp = churn.ChurnParams(model="lifetime", target_num=16,
                                   init_interval=0.5, init_deviation=0.0,
                                   lifetime_mean=40.0)
            sp, pp, bp = (ScribeParams(num_groups=3), P2pnsParams(),
                          BroadcastTestParams())
        logic = ChordLogic(app=TierStack([
            ScribeApp(sp), P2pnsApp(pp, num_slots=cp.num_slots),
            BroadcastTestApp(bp)]))
    impl = "sparse" if label == "stack_sparse" else "dense"
    return Simulation(logic, cp, UnderlayParams(jitter=0.0), EngineParams(
        inbox_impl=inbox_impl, tick_impl=impl, **ep), device=device)


def dht_sim(target, device, inbox_impl, *, tick_impl="dense",
            deviation=None, jitter=0.1):
    """The DHT path: Kademlia (``LookupConfig(slots=8, merge=True)``) +
    DHT + DHTTestApp with default.ini's DHT settings under LifetimeChurn
    (2 * ``target`` slots, Weibull mean 1,000 s, graceful leave at its
    defaults), this script's R and MOUT."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.dht import DhtApp, DhtParams
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.kademlia import KademliaLogic
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    app = DhtApp(DhtParams(num_replica=4, num_get_requests=4,
                           ratio_identical=0.5, test_interval=60.0,
                           test_ttl=300.0, storage_slots=32,
                           num_test_keys=16384))
    logic = KademliaLogic(app=app, lcfg=LookupConfig(slots=8, merge=True))
    cp = churn.ChurnParams(
        model="lifetime", target_num=target, init_interval=20.0 / target,
        init_deviation=2.0 / target if deviation is None else deviation,
        lifetime_mean=1000.0, lifetime_dist="weibull", lifetime_par1=1.0)
    ep = EngineParams(window=0.2, inbox_slots=R, outbox_slots=MOUT,
                      pool_factor=POOL_FACTOR, inbox_impl=inbox_impl,
                      tick_impl=tick_impl)
    return Simulation(logic, cp, UnderlayParams(jitter=jitter), ep,
                      device=device)


def tiny_dht_sim(device, inbox_impl, overlay="kad", tick_impl="dense",
                 target=8):
    """tests/test_torch_dht.py's configuration: DHT (test interval 2 s,
    a ring of 64 keys, 8 storage slots) over Kademlia or Chord under
    lifetime churn (mean 8 s, 1 s graceful leave) at 2 * ``target``
    slots, normal draws off; the app's hook tally is on."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.dht import DhtApp, DhtParams
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.chord import ChordLogic
    from oversim_tpu_torch.overlay.kademlia import KademliaLogic
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    app = DhtApp(DhtParams(test_interval=2.0, num_test_keys=64,
                           storage_slots=8))
    app.tally = {}
    if overlay == "kad":
        logic = KademliaLogic(app=app, lcfg=LookupConfig(slots=8, merge=True))
    else:
        logic = ChordLogic(app=app, lcfg=LookupConfig(slots=8))
    cp = churn.ChurnParams(model="lifetime", target_num=target,
                           init_interval=0.2, init_deviation=0.0,
                           lifetime_mean=8.0, graceful_leave_delay=1.0)
    ep = EngineParams(window=0.1, inbox_slots=4, pool_factor=4,
                      inbox_impl=inbox_impl, tick_impl=tick_impl)
    return Simulation(logic, cp, UnderlayParams(jitter=0.0), ep,
                      device=device)


def main_ini(n):
    """The main path's scenario as an ini (``[Config Main]``): Kademlia +
    KBRTest at test interval 0.2 s, NoChurn over a 20 s ramp, the
    kernels.  The ini has no key for the engine's window and slots."""
    return ("[Config Main]\n" + KAD_INI + KBR_INI
            + f"**.targetOverlayTerminalNum = {n}\n"
            + f"**.initPhaseCreationInterval = {20.0 / n}s\n"
            + '**.inboxImpl = "pallas"\n')


def pareto_ini(n):
    """``pareto_path``'s scenario (``[Config Pareto]``): BASELINE config
    3's churn (ParetoChurn, ``lifetimeMean = deadtimeMean = 1000s``)
    under Kademlia + KBRTest, ``n`` target nodes over a 20 s ramp."""
    return ("[Config Pareto]\n" + KAD_INI + KBR_INI
            + '**.churnGeneratorTypes = "oversim.common.ParetoChurn"\n'
            + f"**.targetOverlayTerminalNum = {n}\n"
            + f"**.initPhaseCreationInterval = {20.0 / n}s\n"
            + "**.lifetimeMean = 1000s\n**.deadtimeMean = 1000s\n"
            + '**.inboxImpl = "pallas"\n')


def pastry_ini(n):
    """``pastry_path``'s scenario (``[Config Pastry]``): ``pareto_ini``'s
    churn, ramp and KBRTest with Pastry as the overlay."""
    return ("[Config Pastry]\n" + PASTRY_INI + KBR_INI
            + '**.churnGeneratorTypes = "oversim.common.ParetoChurn"\n'
            + f"**.targetOverlayTerminalNum = {n}\n"
            + f"**.initPhaseCreationInterval = {20.0 / n}s\n"
            + "**.lifetimeMean = 1000s\n**.deadtimeMean = 1000s\n"
            + '**.inboxImpl = "pallas"\n')


def main_engine_params(inbox_impl="pallas"):
    """The main path's EngineParams (``bench_sim``'s)."""
    from oversim_tpu_torch.engine.sim import EngineParams
    return EngineParams(window=0.2, inbox_slots=R, pool_factor=POOL_FACTOR,
                        outbox_slots=MOUT, inbox_impl=inbox_impl)


def normals_off(sim):
    """The engine's two normal draws off (card against CPU: ``erfinv``)."""
    import dataclasses
    sim.cp = dataclasses.replace(sim.cp, init_deviation=0.0)
    sim.up = dataclasses.replace(sim.up, jitter=0.0)
    return sim


def tiny_trace():
    """``ini_reference``'s trace: 16 nodes joining over 1.6 s, 40
    PUT/GET lines on 8 keys, one DISCONNECT_NODETYPES/CONNECT_NODETYPES
    pair (types 0 -> 1, 3.0 to 4.5 s), 3 LEAVEs (numpy seed 1)."""
    import numpy as np
    rs = np.random.RandomState(1)
    lines = [f"{0.1 * i:.3f} {i + 1} JOIN" for i in range(16)]
    for k in range(40):
        t = 2.0 + 5.5 * k / 40
        node, key = rs.randint(1, 17), f"key{rs.randint(0, 8)}"
        lines.append(f"{t:.3f} {node} PUT {key} val{k}" if k % 2 == 0
                     else f"{t:.3f} {node} GET {key}")
    lines += ["3.0 0 DISCONNECT_NODETYPES 0 1",
              "4.5 0 CONNECT_NODETYPES 0 1"]
    lines += [f"{6 + 0.5 * j:.3f} {16 - j} LEAVE" for j in range(3)]
    return "\n".join(lines) + "\n"


# ini_reference's scenarios: name -> (ini text, config, trace text or None)
INI_REF = {
    "pareto": ("[Config C]\n" + KAD_INI + KBR_INI
               + '**.churnGeneratorTypes = "oversim.common.ParetoChurn"\n'
               "**.targetOverlayTerminalNum = 8\n"
               "**.initPhaseCreationInterval = 0.1s\n"
               "**.lifetimeMean = 60s\n**.deadtimeMean = 40s\n", "C", None),
    "random": ("[Config C]\n" + KAD_INI + KBR_INI
               + '**.churnGeneratorTypes = "oversim.common.RandomChurn"\n'
               "**.targetOverlayTerminalNum = 8\n"
               "**.initPhaseCreationInterval = 0.1s\n", "C", None),
    "pareto_shifted": ("[Config C]\n" + KAD_INI + KBR_INI
                       + '**.churnGeneratorTypes = '
                       '"oversim.common.LifetimeChurn"\n'
                       '**.lifetimeDistName = "pareto_shifted"\n'
                       "**.lifetimeDistPar1 = 3\n**.lifetimeMean = 60s\n"
                       "**.targetOverlayTerminalNum = 8\n"
                       "**.initPhaseCreationInterval = 0.1s\n", "C", None),
    "trace_dht": ("[Config C]\n" + KAD_INI + DHT_INI, "C", "tiny"),
    "sparse": ("[Config C]\n" + KAD_INI + KBR_INI
               + '**.churnGeneratorTypes = "oversim.common.ParetoChurn"\n'
               '**.tickImpl = "sparse"\n'
               "**.targetOverlayTerminalNum = 8\n"
               "**.initPhaseCreationInterval = 0.1s\n"
               "**.lifetimeMean = 60s\n**.deadtimeMean = 40s\n", "C", None),
}


def ini_ref_sim(name, device, inbox_impl):
    """``ini_reference``'s scenario ``name`` built from its ini text on
    ``device`` with ``inbox_impl``, normal draws off."""
    import dataclasses
    from oversim_tpu_torch import trace
    from oversim_tpu_torch.config.ini import IniFile
    from oversim_tpu_torch.config.scenario import build_simulation
    text, config, tr = INI_REF[name]
    events = trace.parse_text(tiny_trace()) if tr else None
    sim = normals_off(build_simulation(IniFile.loads(text), config,
                                       trace_events=events, device=device))
    sim.ep = dataclasses.replace(sim.ep, inbox_impl=inbox_impl)
    return sim


# pastry_reference's configurations (tests/test_torch_pastry*.py and
# test_torch_route_modes.py): 12 target under lifetime churn (24 slots),
# normal draws off; the DHT one from an ini and tiny_trace()'s 16 nodes
PASTRY_REF = ("pastry", "pastry_iter", "bamboo", "chord_semi", "chord_full",
              "chord_source", "pastry_dht_ini", "pastry_sparse")
PASTRY_DHT_TICKS = 80


def tiny_route_sim(name, device, inbox_impl):
    """``pastry_reference``'s configuration ``name`` on ``device``."""
    from oversim_tpu_torch import churn, trace
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.common.route import RouteConfig
    from oversim_tpu_torch.config.ini import IniFile
    from oversim_tpu_torch.config.scenario import build_simulation
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.chord import ChordLogic
    from oversim_tpu_torch.overlay.pastry import (BambooLogic, PastryLogic,
                                                  PastryParams)
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    ep = EngineParams(window=0.1, inbox_slots=4, pool_factor=4,
                      inbox_impl=inbox_impl,
                      tick_impl="sparse" if name == "pastry_sparse"
                      else "dense")
    if name == "pastry_dht_ini":
        return normals_off(build_simulation(
            IniFile.loads("[Config C]\n" + PASTRY_INI + DHT_INI), "C",
            engine_params=ep, trace_events=trace.parse_text(tiny_trace()),
            device=device))
    kp = KbrTestParams(test_interval=1.0, rpc_test=True)
    if name.startswith("chord"):
        rc = RouteConfig(mode=name.split("_")[1])
        logic = ChordLogic(app=KbrTestApp(kp, rcfg=rc), rcfg=rc,
                           lcfg=LookupConfig(slots=8))
    elif name == "bamboo":
        logic = BambooLogic(app=KbrTestApp(kp))
    else:
        logic = PastryLogic(app=KbrTestApp(kp), params=PastryParams(
            routing_mode="iterative" if name == "pastry_iter"
            else "semi-recursive"))
    cp = churn.ChurnParams(model="lifetime", target_num=12,
                           init_interval=0.2, init_deviation=0.0,
                           lifetime_mean=8.0, graceful_leave_delay=1.0)
    return Simulation(logic, cp, UnderlayParams(jitter=0.0), ep,
                      device=device)


def campaign_sim(target, device, inbox_impl, *, sample_ticks=CAMP_TEL[0]):
    """The campaign path's simulation: Kademlia + KBRTest (test interval
    0.2 s, ``LookupConfig(slots=8, merge=True)``) under LifetimeChurn
    (Weibull, ``lifetime_par1=1``) at 2 * ``target`` slots on the dense
    tick, this script's R, MOUT and pool factor, jitter 0.1, and a
    telemetry sample every ``sample_ticks`` ticks (0: off) into a ring of
    CAMP_TEL[1]; the lifetime mean is the campaign's sweep axis."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.kademlia import KademliaLogic
    from oversim_tpu_torch.telemetry import TelemetryParams
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    logic = KademliaLogic(app=KbrTestApp(KbrTestParams(test_interval=0.2)),
                          lcfg=LookupConfig(slots=8, merge=True))
    cp = churn.ChurnParams(
        model="lifetime", target_num=target, init_interval=20.0 / target,
        init_deviation=2.0 / target, lifetime_mean=CAMP_SWEEP[0][1][0],
        lifetime_dist="weibull", lifetime_par1=1.0)
    ep = EngineParams(window=0.2, inbox_slots=R, outbox_slots=MOUT,
                      pool_factor=POOL_FACTOR, inbox_impl=inbox_impl,
                      telemetry=TelemetryParams(sample_ticks=sample_ticks,
                                                window=CAMP_TEL[1]))
    return Simulation(logic, cp, UnderlayParams(jitter=0.1), ep,
                      device=device)


def campaign_of(sim, replica_ids=None):
    """The campaign path's replicas: CAMP_REPLICAS seeds from
    CAMP_SEED at each lifetime mean of CAMP_SWEEP (or the rows
    ``replica_ids`` of that campaign)."""
    from oversim_tpu_torch.campaign import Campaign, CampaignParams
    return Campaign(sim, CampaignParams(replicas=CAMP_REPLICAS,
                                        base_seed=CAMP_SEED,
                                        sweep=CAMP_SWEEP,
                                        replica_ids=replica_ids))


def tiny_campaign(device, inbox_impl, tick_impl="dense"):
    """``campaign_reference``'s campaigns: Kademlia + KBRTest (test
    interval 1 s) under lifetime churn at 16 slots (mean 8 s, 1 s
    graceful leave, normal draws off).  The dense one sweeps
    ``engine.window`` over (0.1, 0.2) and ``app.testMsgInterval`` over
    (1, 2) s (S = 4) with a telemetry sample every 4 ticks into a ring
    of 8; the sparse one is two seed replicas, telemetry off."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.campaign import Campaign, CampaignParams
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.kademlia import KademliaLogic
    from oversim_tpu_torch.telemetry import TelemetryParams
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    dense = tick_impl == "dense"
    cp = churn.ChurnParams(model="lifetime", target_num=8,
                           init_interval=0.2, init_deviation=0.0,
                           lifetime_mean=8.0, graceful_leave_delay=1.0)
    ep = EngineParams(window=0.1, inbox_slots=4, pool_factor=4,
                      inbox_impl=inbox_impl, tick_impl=tick_impl,
                      telemetry=TelemetryParams(sample_ticks=4 if dense
                                                else 0, window=8))
    sim = Simulation(
        KademliaLogic(app=KbrTestApp(KbrTestParams(test_interval=1.0))), cp,
        UnderlayParams(jitter=0.0), ep, device=device)
    cpar = (CampaignParams(replicas=1, base_seed=SEED, sweep=(
        ("engine.window", (0.1, 0.2)), ("app.testMsgInterval", (1.0, 2.0))))
        if dense else CampaignParams(replicas=2, base_seed=SEED))
    return Campaign(sim, cpar)


def service_argv(n):
    """``python -m oversim_tpu_torch.service`` flags for ``bench_sim(n,
    ..., "pallas")``'s scenario, served in SVC_WINDOW_S windows of
    SVC_CHUNK ticks."""
    return ["--n", str(n), "--seed", str(SEED), "--overlay", "kademlia",
            "--churn", "none", "--interval", "0.2", "--engine-window", "0.2",
            "--inbox-slots", str(R), "--outbox-slots", str(MOUT),
            "--init-interval", repr(20.0 / n),
            "--init-deviation", repr(2.0 / n), "--inbox-impl", "pallas",
            "--window-sim-s", repr(SVC_WINDOW_S), "--chunk", str(SVC_CHUNK)]


def same_scenario(a, b) -> bool:
    """Two Simulations of one static configuration (a checkpoint of one
    resumes bit-identically in the other)."""
    def key(sim):
        lg = sim.logic
        return (sim.cp, sim.up, sim.ep, type(lg), lg.p, lg.lcfg,
                lg.key_spec, type(lg.app), getattr(lg.app, "p", None))
    return key(a) == key(b)


def ingest_sim(n, device, inbox_impl):
    """The ingest path: Kademlia (``LookupConfig(slots=8, merge=True)``) +
    ``RealworldEchoApp(transform=INGEST_TRANSFORM)`` under NoChurn at
    ``n`` nodes, the main path's ramp and widths, EXT_OUT to the gateway
    slot 0 held in the pool (``ext_hold_slot=0``)."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.realworld import RealworldEchoApp
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.kademlia import KademliaLogic
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    logic = KademliaLogic(app=RealworldEchoApp(transform=INGEST_TRANSFORM),
                          lcfg=LookupConfig(slots=8, merge=True))
    cp = churn.ChurnParams(model="none", target_num=n,
                           init_interval=20.0 / n, init_deviation=2.0 / n)
    ep = EngineParams(window=0.2, inbox_slots=R, outbox_slots=MOUT,
                      pool_factor=POOL_FACTOR, inbox_impl=inbox_impl,
                      ext_hold_slot=0)
    return Simulation(logic, cp, UnderlayParams(jitter=0.1), ep,
                      device=device)


def tiny_service_runners(device, inbox_impl):
    """``service_reference``'s runners, tests/test_torch_service_resume.py's
    configuration: Kademlia and Chord + KBRTest (``LookupConfig(slots=4)``)
    under lifetime churn at 24 slots (target 12, mean 8 s), window 0.1 s,
    4 inbox slots, pool factor 4, normal draws off; solo from seed 5, and
    a campaign of four Kademlia seed replicas from base seed 7.  Returns
    {label: (runner, init, ServiceLoop keywords)}."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.campaign import Campaign, CampaignParams
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.chord import ChordLogic
    from oversim_tpu_torch.overlay.kademlia import KademliaLogic
    from oversim_tpu_torch.service import campaign_summarize_leaves
    from oversim_tpu_torch.underlay.simple import UnderlayParams

    def sim(overlay):
        app = KbrTestApp(KbrTestParams(test_interval=0.5))
        lcfg = LookupConfig(slots=4, merge=overlay == "kademlia")
        logic = (KademliaLogic(app=app, lcfg=lcfg) if overlay == "kademlia"
                 else ChordLogic(app=app, lcfg=lcfg))
        cp = churn.ChurnParams(model="lifetime", target_num=12,
                               init_interval=0.2, init_deviation=0.0,
                               lifetime_mean=8.0)
        ep = EngineParams(window=0.1, inbox_slots=4, pool_factor=4,
                          inbox_impl=inbox_impl)
        return Simulation(logic, cp, UnderlayParams(jitter=0.0), ep,
                          device=device)

    kad, chord = sim("kademlia"), sim("chord")
    camp = Campaign(sim("kademlia"), CampaignParams(replicas=4, base_seed=7))
    return {"kademlia": (kad, lambda: kad.init(5), {}),
            "chord": (chord, lambda: chord.init(5), {}),
            "campaign": (camp, camp.init,
                         {"summarize": campaign_summarize_leaves})}


def serve(runner, state, windows, **kw):
    """``windows`` windows of SVC_REF's cadence from ``state``."""
    from oversim_tpu_torch.service import ServiceLoop, ServiceParams
    params = ServiceParams(window_sim_s=SVC_REF["window_s"],
                           chunk=SVC_REF["chunk"],
                           checkpoint_every=kw.pop("every", 0),
                           checkpoint_path=kw.pop("path", None))
    state, done = ServiceLoop(runner, state, params, **kw).run(
        n_windows=windows)
    if done != windows:
        raise AssertionError(f"served {done} of {windows} windows")
    return state


def ptxas_summary(log):
    """``{kernel: [registers, stack frame bytes, spill store bytes]}``
    from an ``nvcc -Xptxas -v`` log."""
    import re
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?_Z(\d+)",
                      ln)
        if m:
            cur = ln[m.end():m.end() + int(m.group(1))]
            out.setdefault(cur, [None, None, None])
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
        if m and cur:
            out[cur][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            out[cur][0] = int(m.group(1))
    return out


# -- kernel checks ----------------------------------------------------------

def make_pool(rng, valid, dst, t, w, device):
    """A message pool of ``len(valid)`` slots with random payload words,
    the given destinations and (for valid slots) delivery times."""
    import numpy as np
    import torch
    from oversim_tpu_torch.engine import pool as pool_mod
    p = len(valid)
    base = pool_mod.empty(p, 5, w - len(pool_mod.SCAL_COLS) - 5, device)
    blk = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, size=(p, w),
                                       dtype=np.int64).astype(np.int32),
                          device=device)
    blk[:, pool_mod._COL["dst"]] = torch.as_tensor(dst, device=device)
    v = torch.as_tensor(valid, device=device)
    return pool_mod.MsgPool(
        valid=v,
        t_deliver=torch.where(v, torch.as_tensor(t, device=device),
                              pool_mod.T_INF),
        stamp=base.stamp, blk=blk, kl=base.kl, rmax=base.rmax)


def hot_case(rng, n, p, w, device):
    """Every slot valid, half of them to 10 hot destinations (about P/20
    each), delivery times in [0, 4): the R-overflow case."""
    import numpy as np
    import torch
    hot = rng.integers(0, n, size=10)
    dst = np.where(rng.random(p) < 0.5, hot[rng.integers(0, 10, size=p)],
                   rng.integers(0, n, size=p)).astype(np.int32)
    pool = make_pool(rng, np.ones(p, bool), dst,
                     rng.integers(0, 4, size=p).astype(np.int64), w, device)
    return ("r_overflow_hot", pool, 10,
            torch.ones(n, dtype=torch.bool, device=device), None)


def inbox_cases(n, p, r, w, device, seed=7):
    """(name, pool, t_end, alive, hold) cases with tie pressure."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    cases = []
    for occ in (0.0, 0.15, 0.5, 0.85, 1.0):
        pool = make_pool(rng, rng.random(p) < occ,
                         rng.integers(0, n, size=p).astype(np.int32),
                         rng.integers(0, 6, size=p).astype(np.int64), w,
                         device)
        alive = torch.as_tensor(rng.random(n) < 0.8, device=device)
        cases.append((f"occupancy_{occ}", pool,
                      int(rng.integers(1, 8)), alive, None))
    cases.append(hot_case(rng, n, p, w, device))
    pool = make_pool(rng, rng.random(p) < 0.7,
                     rng.integers(0, n, size=p).astype(np.int32),
                     rng.integers(0, 6, size=p).astype(np.int64), w, device)
    cases.append(("hold_mask", pool, 6,
                  torch.as_tensor(rng.random(n) < 0.8, device=device),
                  torch.as_tensor(rng.random(p) < 0.3, device=device)))
    return cases


REPEATS = 50    # calls per case, back to back: a look-back race shows
                # only now and then


def repeated(fn, args, repeats):
    """``repeats`` calls of ``fn(*args)`` back to back, then one
    synchronisation (a fault surfaces here, not later)."""
    import torch
    outs = [fn(*args) for _ in range(repeats)]
    if args[0].is_cuda:
        torch.cuda.synchronize(args[0].device)
    return outs


def check_inbox_case(what, n, pool, t_end, alive, hold, repeats):
    """Both inbox entries on one pool, ``repeats`` times each: every result
    equal to the plain version and to the scatter-min oracle
    (``build_inbox_scatter``); returns the largest difference (0)."""
    import torch
    from oversim_tpu_torch.engine import pool as pool_mod
    from oversim_tpu_torch.kernels import inbox as inbox_k
    dev = pool.valid.device
    t_end = torch.tensor(t_end, dtype=torch.int64, device=dev)
    due, _ = pool_mod.due_masks(pool, n, t_end, alive, hold)
    dstc = torch.clamp(pool.dst, 0, n - 1).contiguous()
    oracle = pool_mod.build_inbox_scatter(pool, n, R, t_end, alive, hold)
    worst = 0
    for name, args in (
            ("inbox_select_gather", (due, dstc, pool.t_deliver, pool.blk, n,
                                     R)),
            ("inbox_select", (due, dstc, pool.t_deliver, n, R))):
        kern = getattr(inbox_k, name)
        want = getattr(inbox_k, PLAIN[name])(*args)
        for k, got in enumerate(repeated(kern, args, repeats)):
            for a, b, field in zip(got, want, ("inbox", "delivered", "gblk")):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} {what} (call {k}): {field} "
                                         "differs from the plain version")
            if not (torch.equal(got[0], oracle[0])
                    and torch.equal(got[1], oracle[1])):
                raise AssertionError(f"{name} {what} (call {k}): differs "
                                     "from build_inbox_scatter")
            worst = max(worst, int((got[0].long() - want[0].long()).abs()
                                   .max()))
    return worst


def check_inbox(n, device, repeats=REPEATS, seed=7):
    """Both inbox entries on ``inbox_cases`` pools at P = POOL_FACTOR * n;
    returns (largest difference, cases)."""
    p, w = POOL_FACTOR * n, 10 + 5 + 16
    cases = inbox_cases(n, p, R, w, device, seed=seed)
    worst = max(check_inbox_case(name, n, pool, t_end, alive, hold, repeats)
                for name, pool, t_end, alive, hold in cases)
    return worst, len(cases)


def inbox_edge_cases(n, device, seed=41):
    """(name, n, pool, t_end, alive, hold): every due message to one
    destination, all delivery times equal, a single destination, and
    destination counts at a scan tile and one either side of it."""
    import numpy as np
    import torch
    from oversim_tpu_torch.kernels import inbox as inbox_k
    rng = np.random.default_rng(seed)
    w = 10 + 5 + 16

    def case(name, n, dst, t, occ=1.0):
        p = len(dst)
        pool = make_pool(rng, rng.random(p) < occ, dst.astype(np.int32),
                         t.astype(np.int64), w, device)
        return (name, n, pool, 7,
                torch.ones(n, dtype=torch.bool, device=device), None)

    p = POOL_FACTOR * n
    out = [case("one_destination", n, np.full(p, rng.integers(0, n)),
                rng.integers(0, 8, size=p)),
           case("equal_times", n, rng.integers(0, n, size=p),
                np.full(p, 3)),
           case("n_1", 1, np.zeros(POOL_FACTOR), rng.integers(0, 8,
                                                            POOL_FACTOR)),
           case("n_1_big_bucket", 1, np.zeros(4096),
                rng.integers(0, 8, 4096))]
    tile = inbox_k.SCAN_TILE
    for m in (tile - 1, tile, tile + 1):
        out.append(case(f"n_{m}", m, rng.integers(0, m, size=POOL_FACTOR * m),
                        rng.integers(0, 8, size=POOL_FACTOR * m), occ=0.6))
    return out


def check_inbox_edges(n, device, repeats=REPEATS):
    """``inbox_edge_cases``, each ``repeats`` times on both entries;
    returns (largest difference, cases)."""
    cases = inbox_edge_cases(n, device)
    worst = max(check_inbox_case(name, m, pool, t_end, alive, hold, repeats)
                for name, m, pool, t_end, alive, hold in cases)
    return worst, len(cases)


def exact_mask(rng, m, k):
    """A mask of ``m`` bytes with exactly ``k`` set, at random places."""
    import numpy as np
    mask = np.zeros(m, bool)
    mask[rng.choice(m, k, replace=False)] = True
    return mask


def compact_cases(m, cap, seed=31):
    """(name, mask, cap, byte offset of the mask view): at (m, cap) none
    and all set, random masks at several densities, set counts of cap - 1,
    cap and cap + 1 and a mask viewed at a 1-byte offset; m = 0 and 1; m
    at a tile and one either side of it, and none and all set, under a
    cap above m."""
    import numpy as np
    from oversim_tpu_torch.kernels import compact as compact_k
    rng = np.random.default_rng(seed)
    tile = compact_k.TILE
    out = [("none_set", np.zeros(m, bool), cap, 0),
           ("all_set", np.ones(m, bool), cap, 0)]
    out += [(f"density_{f}", rng.random(m) < f, cap, 0)
            for f in (0.001, 0.01, 0.05, 0.125, 0.124, 0.2, 0.5)]
    out += [(f"count_{k}", exact_mask(rng, m, k), cap, 0)
            for k in (cap - 1, cap, cap + 1)]
    out.append(("view_offset_1", rng.random(m) < 0.3, cap, 1))
    out += [("m_0", np.zeros(0, bool), cap, 0),
            ("m_1_set", np.ones(1, bool), cap, 0),
            ("m_1_clear", np.zeros(1, bool), cap, 0)]
    out += [(f"m_{k}_cap_above_m", rng.random(k) < 0.5, 2 * tile, 0)
            for k in (tile - 1, tile, tile + 1)]
    k = 3 * tile + 5
    out += [("none_set_cap_above_m", np.zeros(k, bool), 4 * tile, 0),
            ("all_set_cap_above_m", np.ones(k, bool), 4 * tile, 0)]
    return out


def check_compact_case(what, mask, cap, offset, device, repeats, rng):
    """``compact_indices`` on one mask (a view ``offset`` bytes into its
    buffer), ``repeats`` times: every result equal to the plain version,
    the count equal to the set bits; returns the largest difference (0)."""
    import numpy as np
    import torch
    from oversim_tpu_torch.kernels import compact as compact_k
    m = len(mask)
    buf = torch.zeros((m + offset,), dtype=torch.bool, device=device)
    buf[offset:] = torch.as_tensor(mask, device=device)
    mk = buf[offset:]
    vals = torch.as_tensor(rng.permutation(m).astype(np.int32), device=device)
    args = (mk, vals, cap, m)
    lb, cb = compact_k.compact_indices_plain(*args)
    if int(cb) != int(mask.sum()):
        raise AssertionError(f"compact_indices {what}: plain count wrong")
    worst = 0
    for k, (la, ca) in enumerate(repeated(compact_k.compact_indices, args,
                                          repeats)):
        if not (torch.equal(la, lb) and int(ca) == int(cb)):
            raise AssertionError(f"compact_indices {what} (call {k}): "
                                 "differs from the plain version")
        worst = max(worst, int((la.long() - lb.long()).abs().max()))
    return worst


def check_compact(m, cap, device, repeats=REPEATS):
    """``compact_cases``, each ``repeats`` times; returns (largest
    difference, cases)."""
    import numpy as np
    rng = np.random.default_rng(32)
    cases = compact_cases(m, cap)
    worst = max(check_compact_case(name, mask, c, off, device, repeats, rng)
                for name, mask, c, off in cases)
    return worst, len(cases)


def gather_cases(seed=37):
    """(name, inbox, blk): W in {1, 2, 4, 31, 32, 33} at N = 1,001, R = 3
    (so N R W is odd for odd W) with 30% of the entries empty, and at W =
    31 every entry empty and every entry full."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n, r = 1001, 3
    p = POOL_FACTOR * n

    def case(name, w, empty):
        inbox = rng.integers(0, p, size=(n, r)).astype(np.int32)
        inbox[rng.random((n, r)) < empty] = -1
        blk = rng.integers(-2**31, 2**31 - 1, size=(p, w),
                           dtype=np.int64).astype(np.int32)
        return name, inbox, blk

    return ([case(f"w_{w}", w, 0.3) for w in (1, 2, 4, 31, 32, 33)]
            + [case("all_empty", 31, 1.0), case("all_full", 31, 0.0)])


def check_gather_case(what, inbox, blk, repeats):
    """``inbox_gather`` on one (inbox, blk) pair of device tensors,
    ``repeats`` times: every result equal to the plain version; returns
    the largest difference (0)."""
    import torch
    from oversim_tpu_torch.kernels import inbox as inbox_k
    want = inbox_k.inbox_gather_plain(inbox, blk)
    for k, got in enumerate(repeated(inbox_k.inbox_gather, (inbox, blk),
                                     repeats)):
        if not torch.equal(got, want):
            raise AssertionError(f"inbox_gather {what} (call {k}): differs "
                                 "from the plain version")
    return 0


def check_gather(device, repeats=REPEATS):
    """``gather_cases``, each ``repeats`` times; returns (largest
    difference, cases)."""
    import torch
    cases = gather_cases()
    worst = max(check_gather_case(name, torch.as_tensor(inbox, device=device),
                                  torch.as_tensor(blk, device=device),
                                  repeats)
                for name, inbox, blk in cases)
    return worst, len(cases)


def check_alloc_case(what, valid, want, device, repeats):
    """``alloc_dest`` on one (valid, want) pair, ``repeats`` times: every
    result equal to the plain version and to ``pool.alloc_dest_cumsum``;
    returns the largest difference (0)."""
    import torch
    from oversim_tpu_torch.engine import pool as pool_mod
    from oversim_tpu_torch.kernels import outbox as outbox_k
    v = torch.as_tensor(valid, device=device)
    wt = torch.as_tensor(want, device=device)
    d2, o2 = outbox_k.alloc_dest_plain(v, wt)
    d3, o3 = pool_mod.alloc_dest_cumsum(v, wt)
    if not (torch.equal(d2, d3) and int(o2) == int(o3)):
        raise AssertionError(f"alloc_dest {what}: plain version and "
                             "alloc_dest_cumsum differ")
    worst = 0
    for k, (d1, o1) in enumerate(repeated(outbox_k.alloc_dest, (v, wt),
                                          repeats)):
        if not (torch.equal(d1, d2) and int(o1) == int(o2)
                and o1.dtype == o2.dtype):
            raise AssertionError(f"alloc_dest {what} (call {k}): differs "
                                 "from its plain version")
        worst = max(worst, int((d1.long() - d2.long()).abs().max())
                    if d1.numel() else 0)
    return worst


def check_alloc(n, device, draws=20, repeats=REPEATS):
    """``alloc_dest`` at P = POOL_FACTOR * n, Q = MOUT * n: nothing free,
    everything valid, random draws; returns (largest difference, cases)."""
    import numpy as np
    rng = np.random.default_rng(17)
    p, q = POOL_FACTOR * n, MOUT * n
    cases = [(np.zeros(p, bool), np.ones(q, bool)),
             (np.ones(p, bool), rng.random(q) < 0.6)]
    cases += [(rng.random(p) < rng.random(), rng.random(q) < 0.6)
              for _ in range(draws)]
    worst = max(check_alloc_case(f"draw {i}", valid, want, device, repeats)
                for i, (valid, want) in enumerate(cases))
    return worst, len(cases)


def alloc_edge_cases(seed=43):
    """(name, valid, want): P and Q at the smallest sizes, at a scan tile
    and one either side of it; no free slot; every slot free and every
    message wanted; more wanted than free with the crossing inside a
    tile and on a tile edge; the sparse path's 0.1% wanted."""
    import numpy as np
    from oversim_tpu_torch.kernels import outbox as outbox_k
    rng = np.random.default_rng(seed)
    tile = outbox_k.TILE
    out = [(f"p{p}_q{q}", rng.random(p) < 0.5, rng.random(q) < 0.6)
           for p, q in ((1, 1), (1, tile), (tile, 1), (tile - 1, tile + 1),
                        (tile, tile), (tile + 1, tile - 1),
                        (3 * tile + 1, 5 * tile - 1))]
    p, q = 3 * tile, 4 * tile

    def with_free(k):
        valid = np.ones(p, bool)
        valid[rng.choice(p, k, replace=False)] = False
        return valid

    out += [("no_free_slot", np.ones(p, bool), np.ones(q, bool)),
            ("all_free_all_wanted", np.zeros(p, bool), np.ones(p, bool)),
            ("crossing_inside_tile", with_free(tile + 100), np.ones(q, bool)),
            ("crossing_on_tile_edge", with_free(2 * tile), np.ones(q, bool))]
    n_sp = 2 * TGT_SPARSE
    out.append(("sparse_0.1pct_wanted", rng.random(POOL_FACTOR * n_sp) < 0.3,
                rng.random(MOUT * n_sp) < 0.001))
    return out


def check_alloc_edges(device, repeats=REPEATS):
    """``alloc_edge_cases``, each ``repeats`` times; returns (largest
    difference, cases)."""
    cases = alloc_edge_cases()
    worst = max(check_alloc_case(name, valid, want, device, repeats)
                for name, valid, want in cases)
    return worst, len(cases)


# -- state comparison ---------------------------------------------------------

def flat_state(x):
    """A port state as ``{leaf path: array}`` (a dict is one already)."""
    from oversim_tpu_torch import interop
    return x if isinstance(x, dict) else interop.state_to_numpy(x)


def compare_states(a, b, float_rtol=0.0):
    """Leaf-by-leaf comparison of two port states (or ``flat_state``
    dicts); returns the number of leaves, raises naming the first leaf
    that differs."""
    import numpy as np
    fa, fb = flat_state(a), flat_state(b)
    if sorted(fa) != sorted(fb):
        raise AssertionError("state layouts differ")
    for k in sorted(fa):
        x, y = fa[k], fb[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{k}: dtype/shape differ")
        if float_rtol and x.dtype.kind == "f":
            ok = np.allclose(x, y, rtol=float_rtol, atol=0.0, equal_nan=True)
        else:
            ok = np.array_equal(x, y)
        if not ok:
            raise AssertionError(f"first differing leaf: {k}")
    return len(fa)


# -- timing -------------------------------------------------------------------

def _event_ms(run, iters, repeats):
    """Median over ``repeats`` of the CUDA-event time of ``run()`` over
    ``iters``."""
    import torch
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return statistics.median(out)


def time_cuda(fn, iters=20, repeats=5):
    """Median ms per call of ``iters`` calls issued from the host between
    two CUDA events (``call_ms``): for a short kernel the wrapper's host
    work (allocations, the ctypes call) sets the pace."""
    import torch
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _event_ms(run, iters, repeats)


def graph_nodes(graph):
    """``{node kind: count}`` of a captured CUDA graph (kept with
    ``keep_graph=True``), from ``cuGraphGetNodes`` and
    ``cuGraphNodeGetType`` of libcuda."""
    import ctypes
    kinds = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
             5: "empty"}
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    out = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                 ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        key = kinds.get(kind.value, str(kind.value))
        out[key] = out.get(key, 0) + 1
    return out


def time_graph(fn, iters=20, repeats=5):
    """(median device ms per call, ``{node kind: count}`` per call):
    ``iters`` calls captured once into a CUDA graph, which is replayed
    between two CUDA events.  The replay does no host work, so this is
    the calls' kernels and memsets back to back on the card (the
    ``device_ms``); the graph's nodes are the calls' device operations.
    ``fn`` must not synchronise."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ops = {k: v / iters for k, v in graph_nodes(graph).items()}
    graph.replay()
    torch.cuda.synchronize()
    ms = _event_ms(graph.replay, iters, repeats)
    del graph
    return ms, ops


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def call_breakdown(fn, calls=5):
    """One torch.profiler pass over ``calls`` calls: every device
    operation of a call (kernels and memsets) as [name, device µs per
    launch, launches seen per call].  The profiler can drop records, so
    the count of operations per call comes from ``time_graph``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    if not rows:
        return {"ops": "not measured"}
    return {"ops": [[e.key.split("(")[0][:48], _dev_us(e) / e.count,
                     e.count / calls] for e in
                    sorted(rows, key=_dev_us, reverse=True)]}


def _kernel_modules():
    from oversim_tpu_torch.kernels import compact as compact_k
    from oversim_tpu_torch.kernels import inbox as inbox_k
    from oversim_tpu_torch.kernels import outbox as outbox_k
    return {"inbox_select_gather": inbox_k, "inbox_select": inbox_k,
            "inbox_gather": inbox_k, "alloc_dest": outbox_k,
            "compact_indices": compact_k}


def capture_tick_inputs(sim, s, names):
    """Run one more tick with the wrappers of ``names`` wrapped to keep
    their inputs; returns ({kernel: args}, state)."""
    mods = _kernel_modules()
    seen, orig = {}, {name: getattr(mods[name], name) for name in names}

    def keep(name):
        def fn(*args):
            seen[name] = args
            return orig[name](*args)
        return fn

    for name in names:
        setattr(mods[name], name, keep(name))
    try:
        s = sim.step(s)
    finally:
        for name in names:
            setattr(mods[name], name, orig[name])
    return seen, s


def bounds(seen):
    """Least time for each kernel's work on these inputs: every input byte
    the work needs read once, every output byte written once, over the
    HBM rate.  Selection reads the due mask and, for the due messages
    only, their destination and time; the gather reads only the selected
    rows (and row 0 for empty entries); ``inbox_gather`` alone reads the
    inbox, each distinct row it names once, and writes the [N, R, W]
    rows; compaction reads the mask and the values of the set bits."""
    import torch
    ms, work = {}, {}
    if "inbox_select_gather" in seen:
        due, dst, t, blk, n, r = seen["inbox_select_gather"]
        p, w = blk.shape
        n_due = int(torch.sum(due))
        rows = min(n_due, n * r)
        b = p * (1 + 4 + 8) + rows * w * 4 + n * r * 4 + p + n * r * w * 4
        work["inbox_select_gather"] = {"due": n_due, "bytes": b}
    if "inbox_gather" in seen:
        inbox, blk = seen["inbox_gather"]
        (n, r), w = inbox.shape, blk.shape[1]
        rows = int(torch.unique(torch.clamp(inbox, min=0)).numel())
        b = n * r * 4 + rows * w * 4 + n * r * w * 4
        work["inbox_gather"] = {"rows_read": rows, "bytes": b}
    if "inbox_select" in seen:
        due, dst, t, n, r = seen["inbox_select"]
        p = due.shape[0]
        n_due = int(torch.sum(due))
        b = p + n_due * (4 + 8) + n * r * 4 + p
        work["inbox_select"] = {"due": n_due, "bytes": b}
    if "alloc_dest" in seen:
        valid, want = seen["alloc_dest"]
        q = want.shape[0]
        b = valid.shape[0] + q + q * 4 + 4
        work["alloc_dest"] = {"wanted": int(torch.sum(want)), "bytes": b}
    if "compact_indices" in seen:
        mask, vals, cap, _ = seen["compact_indices"]
        cnt = int(torch.sum(mask))
        b = mask.shape[0] + min(cnt, cap) * 4 + cap * 4 + 4
        work["compact_indices"] = {"set": cnt, "cap": cap, "bytes": b}
    for name, wk in work.items():
        ms[name] = wk["bytes"] / HBM_BYTES_PER_S * 1e3
    return ms, work


# -- the CPU halves of the reference phases ----------------------------------

# each reference phase's depth; ``main`` starts every CPU half at these in a
# helper process, which runs them while the card runs the phases before
REF_TICKS = {"reference": 96, "sparse_reference": 48, "chord_reference": 96,
             "chord_sparse_reference": 48, "dht_reference": 72,
             "dht_sparse_reference": 48, "campaign_reference": 24,
             "service_reference": SVC_REF["windows"], "ini_reference": 48,
             "pastry_reference": 48, "koorde_reference": 64,
             "broose_reference": 96, "epichord_reference": 64,
             "inet_reference": 72, "gia_reference": 120,
             "vast_reference": 160, "alm_reference": max(ALM_REF.values()),
             "app_reference": max(APP_REF.values())}
CAMP_UNTIL_S = 5.0
CAMP_SPARSE_TICKS = 24
# ini_reference: the trace scenario runs long enough to cross its
# partition (3.0-4.5 s at the ini's 0.01 s window)
INI_TRACE_TICKS = 256


def cpu_half(name, ticks=None, n=16, until_s=CAMP_UNTIL_S,
             sparse_ticks=CAMP_SPARSE_TICKS):
    """The CPU (torch-ops) half of reference phase ``name``, with that
    phase's arguments: ``{label: flat state}`` (and the DHT's hook
    tallies).  One intra-op thread: the states have 16-24 slots, whose
    operations are too small to share out."""
    import torch
    from oversim_tpu_torch import interop, tree
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    ticks = REF_TICKS[name] if ticks is None else ticks
    if name in ("reference", "chord_reference"):
        build = bench_sim if name == "reference" else chord_sim
        sims = {"state": build(n, cpu, "scatter", deviation=0.0, jitter=0.0,
                               inbox=8, outbox=16)}
    elif name == "sparse_reference":
        sims = {"state": tiny_sparse_sim(cpu, "scatter")}
    elif name == "chord_sparse_reference":
        sims = {"state": tiny_chord_sparse_sim(cpu, "scatter")}
    elif name == "dht_sparse_reference":
        sims = {"state": tiny_dht_sim(cpu, "scatter", tick_impl="sparse",
                                      target=12)}
    elif name == "dht_reference":
        out = {}
        for overlay in ("kad", "chord"):
            b = tiny_dht_sim(cpu, "scatter", overlay)
            out[overlay] = interop.state_to_numpy(
                b.run_chunk(b.init(SEED), ticks))
            out[overlay + "_tally"] = {k: int(v) for k, v in
                                       b.logic.app.tally.items()}
        return out
    elif name == "ini_reference":
        out = {}
        for label in INI_REF:
            b = ini_ref_sim(label, cpu, "scatter")
            t = INI_TRACE_TICKS if INI_REF[label][2] else ticks
            out[label] = interop.state_to_numpy(b.run_chunk(b.init(SEED), t))
        return out
    elif name == "pastry_reference":
        out = {}
        for label in PASTRY_REF:
            b = tiny_route_sim(label, cpu, "scatter")
            t = PASTRY_DHT_TICKS if label == "pastry_dht_ini" else ticks
            out[label] = interop.state_to_numpy(b.run_chunk(b.init(SEED), t))
        return out
    elif name in ("alm_reference", "app_reference"):
        refs, tiny, _ = tier_refs(name.split("_")[0])
        out = {}
        for label, t in refs.items():
            b = tiny(label, cpu, "scatter")
            out[label] = interop.state_to_numpy(b.run_chunk(b.init(SEED), t))
        return out
    elif name.split("_")[0] in GAME_REF:
        out = {}
        for label in GAME_REF[name.split("_")[0]]:
            b = tiny_game_sim(label, cpu, "scatter")
            out[label] = interop.state_to_numpy(b.run_chunk(b.init(SEED),
                                                            ticks))
        return out
    elif name.split("_")[0] in DB_REF:
        out = {}
        for label in DB_REF[name.split("_")[0]]:
            b = tiny_lane_sim(label, cpu, "scatter")
            out[label] = interop.state_to_numpy(b.run_chunk(b.init(SEED),
                                                            ticks))
        return out
    elif name == "service_reference":
        out = {}
        for label, (runner, init, kw) in tiny_service_runners(
                cpu, "scatter").items():
            st = serve(runner, init(), ticks, **kw)
            out[label] = interop.state_to_numpy(
                tree.stack(st) if isinstance(st, list) else st)
        return out
    else:
        cb = tiny_campaign(cpu, "scatter")
        rb = cb.run_chunk(cb.init(), ticks)
        ub = cb.run_until_device(rb, until_s, chunk=8)
        xb = tiny_campaign(cpu, "scatter", tick_impl="sparse")
        yb = xb.run_chunk(xb.init(), sparse_ticks)
        return {k: interop.state_to_numpy(tree.stack(v))
                for k, v in (("chunk", rb), ("until", ub), ("sparse", yb))}
    return {k: interop.state_to_numpy(b.run_chunk(b.init(SEED), ticks))
            for k, b in sims.items()}


def cpu_result(job, name, **kw):
    """The CPU half of ``name``: the helper process's result where ``main``
    started one (``job``), else run here with the phase's arguments."""
    return job.result() if job is not None else cpu_half(name, **kw)


# -- phases -------------------------------------------------------------------

def phase_reference(device, n=16, ticks=REF_TICKS["reference"], cpu=None):
    t0 = time.perf_counter()
    a = bench_sim(n, device, "pallas", deviation=0.0, jitter=0.0, inbox=8,
                  outbox=16)
    sa = a.run_chunk(a.init(SEED), ticks)
    sb = cpu_result(cpu, "reference", n=n, ticks=ticks)["state"]
    leaves = compare_states(sa, sb, float_rtol=1e-12)
    out = a.summary(sa)
    if out["kbr_sent"] <= 0 or out["_alive"] != n:
        raise AssertionError(f"reference run carried no traffic: {out}")
    return {"phase": "reference", "n": n, "ticks": ticks,
            "depth_cut": {"ticks": [128, ticks]}, "leaves": leaves,
            "kbr_sent": out["kbr_sent"], "kbr_delivered": out["kbr_delivered"],
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_identity(device, n, ticks=5):
    from oversim_tpu_torch import tree
    t0 = time.perf_counter()
    a = bench_sim(n, device, "scatter")
    b = bench_sim(n, device, "pallas")
    s0 = a.init(SEED)
    sa = a.run_chunk(tree.tree_map(lambda x: x.clone(), s0), ticks)
    sb = b.run_chunk(tree.tree_map(lambda x: x.clone(), s0), ticks)
    leaves = compare_states(sa, sb)
    return {"phase": "identity", "n": n, "ticks": ticks,
            "depth_cut": {"ticks": [50, ticks]}, "leaves": leaves,
            "alive": int(sa.alive.sum()), "pool_valid": int(sa.pool.valid.sum()),
            "seconds": round(time.perf_counter() - t0, 3)}


def run_window(sim, s, device, kernel_names, warm_s=WARM_S, at_warm=None,
               measure_s=MEASURE_S, chunk=CHUNK):
    """Warm-up to ``warm_s``, then the measured window to ``warm_s`` +
    MEASURE_S, ``chunk`` ticks a dispatch, with the launch counts set to 0
    just before and read just after (``at_warm(state)`` sees the warmed
    state first).  Returns
    (state, summary at the window start, summary at its end, warm-up wall
    s, window wall s, {kernel: launches})."""
    import torch
    from oversim_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.reset_launches()
    s = sim.run_until_device(s, warm_s, chunk=chunk)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if at_warm is not None:
        at_warm(s)
    base = sim.summary(s)
    warm_wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    s = sim.run_until_device(s, warm_s + measure_s, chunk=chunk)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t1
    launches = {k: kernels.LAUNCHES[k] for k in kernel_names}
    return s, base, sim.summary(s), warm_wall, wall, launches


def sync_free_step(sim, s):
    """One more tick with every host synchronisation turned into an error
    (``torch.cuda.set_sync_debug_mode``): the tick must never make the
    host wait for the card."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s = sim.step(s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return s


def window_line(phase, sim, base, out, warm_wall, wall, launches):
    """The path line's common fields and the health gate's inputs."""
    import math
    sent = out["kbr_sent"] - base["kbr_sent"]
    delivered = out["kbr_delivered"] - base["kbr_delivered"]
    ticks = out["_ticks"] - base["_ticks"]
    finite = all(math.isfinite(v) for k in ("kbr_latency_s", "lookup_hops")
                 for v in (out[k]["mean"], out[k]["stddev"]))
    line = {"phase": phase, "n": sim.n, "inbox_impl": sim.ep.inbox_impl,
            "tick_impl": sim.ep.tick_impl,
            "window_s": [base["_t_sim"], out["_t_sim"]],
            "ticks": out["_ticks"], "ticks_measured": ticks,
            "t_sim": out["_t_sim"], "alive": out["_alive"],
            "warm_wall_s": round(warm_wall, 3), "wall_s": round(wall, 3),
            "lookups_per_s": delivered / wall if wall > 0 else 0.0,
            "sim_s_per_wall_s": (out["_t_sim"] - base["_t_sim"]) / wall
            if wall > 0 else 0.0,
            "wall_ms_per_tick": wall * 1e3 / ticks if ticks else 0.0,
            "kbr_sent": sent, "kbr_delivered": delivered,
            "delivery": delivered / sent if sent else 0.0,
            "lookup_hops_mean": out["lookup_hops"]["mean"],
            "engine": out["_engine"], "launches": launches}
    healthy = (sent > 0 and line["delivery"] >= 0.95
               and out["_engine"]["pool_overflow"] == 0
               and out["_engine"]["outbox_overflow"] == 0)
    return line, healthy, finite


def phase_main_path(device, n, keep=None):
    """The main path; ``keep`` (a list) receives a copy of the state
    warmed to WARM_S, the service path's start."""
    from oversim_tpu_torch import tree
    sim = bench_sim(n, device, "pallas")
    at_warm = None if keep is None else (
        lambda st: keep.append(tree.tree_map(lambda x: x.clone(), st)))
    s, base, out, warm_wall, wall, launches = run_window(
        sim, sim.init(SEED), device, DENSE_KERNELS, at_warm=at_warm)
    line, healthy, finite = window_line("main_path", sim, base, out,
                                        warm_wall, wall, launches)
    line["depth_cut"] = {"warm_s": [WARM_S_UNCUT, WARM_S],
                         "measure_s": [MEASURE_S_UNCUT, MEASURE_S]}
    lat = out["kbr_latency_s"], base["kbr_latency_s"]
    n_l = lat[0]["count"] - lat[1]["count"]
    line["latency_mean_window_s"] = (
        (lat[0]["count"] * lat[0]["mean"] - lat[1]["count"] * lat[1]["mean"])
        / n_l if n_l else 0.0)
    emit(line)
    if not healthy:
        raise AssertionError("main path failed the health gate")
    if out["_alive"] != n or not finite:
        raise AssertionError("main path state is not as expected")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    s = sync_free_step(sim, s)
    emit({"phase": "main_path_sync_check", "host_syncs_in_tick": 0})
    return sim, s, launches, line


PLAIN = {"inbox_select_gather": "inbox_select_gather_plain",
         "inbox_select": "inbox_select_plain",
         "inbox_gather": "inbox_gather_plain",
         "alloc_dest": "alloc_dest_plain",
         "compact_indices": "compact_indices_plain"}


def hot_inputs(name, n, device):
    """The arguments of inbox kernel ``name`` on the R-overflow case
    (``hot_case``) at ``n`` destinations and P = POOL_FACTOR * n."""
    import numpy as np
    import torch
    from oversim_tpu_torch.engine import pool as pool_mod
    p, w = POOL_FACTOR * n, 10 + 5 + 16
    _, pool, t_end, alive, hold = hot_case(np.random.default_rng(7), n, p, w,
                                           device)
    t_end = torch.tensor(t_end, dtype=torch.int64, device=device)
    due, _ = pool_mod.due_masks(pool, n, t_end, alive, hold)
    dstc = torch.clamp(pool.dst, 0, n - 1).contiguous()
    if name == "inbox_select_gather":
        return due, dstc, pool.t_deliver, pool.blk, n, R
    return due, dstc, pool.t_deliver, n, R


TIMING_KEYS = ("device_ms", "call_ms", "plain_ms", "library_ms",
               "ops_per_call", "hot_device_ms")


def phase_timing(sim, s, names, phase="timing", lines=None):
    """Each kernel of ``names`` on the inputs of one more tick: its device
    time (``time_graph``), its host-issued call time (``time_cuda``), its
    per-call device operations (``time_graph``, ``call_breakdown``),
    its plain version's and the nearest single library call's time (where
    there is one; both synchronise, so they are timed as calls) and, for
    the inbox kernels, the device time on the R-overflow case at the
    path's shapes; ``ops_per_call`` counts the nodes of a CUDA graph of
    one call.  Where ``names`` holds ``inbox_select_gather``, its gather
    step runs alone too (``inbox_gather``, on the inbox the captured
    inputs select), checked against its plain version first.  Returns
    ({kernel: {key: value}}, bound_ms); the line goes to ``lines`` where
    given (a lane's), else out."""
    import torch
    from oversim_tpu_torch.kernels import inbox as inbox_k
    mods = _kernel_modules()
    seen, _ = capture_tick_inputs(sim, s, names)
    checks = {}
    if "inbox_select_gather" in seen:
        due, dst, t, blk, n, r = seen["inbox_select_gather"]
        inbox = inbox_k.inbox_select_gather(due, dst, t, blk, n, r)[0]
        seen["inbox_gather"] = (inbox, blk)
        names = tuple(names) + ("inbox_gather",)
        checks["inbox_gather"] = {
            "inputs": "the captured tick's inbox", "repeats": REPEATS,
            "max_abs_err": check_gather_case("main path tick", inbox, blk,
                                             REPEATS)}
    bound_ms, work = bounds(seen)
    res, lib_call, breakdown = {}, {}, {}
    for name in names:
        args = seen[name]
        kern, plain = getattr(mods[name], name), getattr(mods[name],
                                                         PLAIN[name])
        device_ms, ops = time_graph(lambda: kern(*args))
        r = {"device_ms": device_ms,
             "call_ms": time_cuda(lambda: kern(*args)),
             "plain_ms": time_cuda(lambda: plain(*args)),
             "library_ms": None, "hot_device_ms": None}
        breakdown[name] = call_breakdown(lambda: kern(*args))
        breakdown[name]["graph_nodes"] = ops
        r["ops_per_call"] = sum(ops.values())
        if name == "compact_indices":
            mask, vals = args[0], args[1]
            r["library_ms"] = time_cuda(lambda: torch.masked_select(vals,
                                                                    mask))
            lib_call[name] = ("torch.masked_select (uncapped, synchronises "
                              "with the host)")
        if name == "inbox_gather":
            inbox, blk = args
            idx = torch.clamp(inbox, min=0).flatten()
            r["library_ms"] = time_graph(
                lambda: torch.index_select(blk, 0, idx))[0]
            lib_call[name] = ("torch.index_select(blk, 0, idx), idx the "
                              "clamped inbox made once before (CUDA graph)")
        if name in ("inbox_select_gather", "inbox_select"):
            due, dst, n = args[0], args[1], args[-2]
            cnt = torch.bincount(dst[due].long(), minlength=n)
            work[name]["buckets"] = {
                "nonempty": int((cnt > 0).sum()), "max": int(cnt.max()),
                "over_32": int((cnt > 32).sum()),
                "over_512": int((cnt > 512).sum())}
            hot = hot_inputs(name, n, args[0].device)
            r["hot_device_ms"] = time_graph(lambda: kern(*hot))[0]
        res[name] = r
    line = {"phase": phase, "work": work}
    line.update({key: {k: v[key] for k, v in res.items()}
                 for key in TIMING_KEYS})
    line.update({"library_call": lib_call, "bound_ms": bound_ms,
                 "checks": checks, "breakdown": breakdown})
    if lines is None:
        emit(line)
    else:
        lines.append(line)
    return res, bound_ms


def phase_profile(sim, s, ticks=1, phase="profile", cut_from=5):
    import torch
    from torch.profiler import ProfilerActivity, profile
    s = sim.run_chunk(s, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = sim.run_chunk(s, ticks)
    torch.cuda.synchronize()
    wall_plain = (time.perf_counter() - t0) / ticks
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run_chunk(s, ticks)
        torch.cuda.synchronize()
    wall_prof = (time.perf_counter() - t0) / ticks
    del plain

    from torch.autograd import DeviceType
    ka = prof.key_averages()
    # device-side rows (kernels, memcpy, memset) carry the device time
    # once; operator rows repeat it as their self device time
    on_dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    ops = [e for e in ka if e.device_type != DeviceType.CUDA]
    dev = sum(_dev_us(e) for e in on_dev) / 1e3 / ticks
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    top = sorted(ops, key=_dev_us, reverse=True)[:10]
    line = {"phase": phase, "ticks": ticks}
    if cut_from is not None:
        line["depth_cut"] = {"ticks": [cut_from, ticks]}
    return {**line, "wall_ms_per_tick": wall_plain * 1e3,
            "wall_ms_per_tick_profiled": wall_prof * 1e3,
            "device_ms_per_tick": dev if dev > 0 else "not measured",
            "device_idle_share": (1.0 - dev / (wall_plain * 1e3))
            if dev > 0 else "not measured",
            "launches_per_tick": launches / ticks,
            "top_device_ops_ms_per_tick": [
                [e.key[:60], _dev_us(e) / 1e3 / ticks, e.count // ticks]
                for e in top]}


def strip_sparse(state):
    """A sparse-tick state in the dense tick's layout (the sparse lane
    tallies dropped from the counters)."""
    import dataclasses
    from oversim_tpu_torch.engine.sim import SPARSE_COUNTERS
    return dataclasses.replace(state, counters={
        k: v for k, v in state.counters.items() if k not in SPARSE_COUNTERS})


def phase_sparse_reference(device, ticks=REF_TICKS["sparse_reference"],
                           cpu=None):
    t0 = time.perf_counter()
    a = tiny_sparse_sim(device, "pallas")
    sa = a.run_chunk(a.init(SEED), ticks)
    sb = cpu_result(cpu, "sparse_reference", ticks=ticks)["state"]
    leaves = compare_states(sa, sb, float_rtol=1e-12)
    out = a.summary(sa)
    eng = out["_engine"]
    if out["kbr_sent"] <= 0 or eng["dest_unavailable_lost"] <= 0:
        raise AssertionError(f"sparse reference saw no traffic or churn: "
                             f"{out}")
    return {"phase": "sparse_reference", "n": a.n, "ticks": ticks,
            "depth_cut": {"ticks": [128, ticks]},
            "leaves": leaves, "kbr_sent": out["kbr_sent"],
            "kbr_delivered": out["kbr_delivered"], "alive": out["_alive"],
            "awake_nodes": eng["awake_nodes"],
            "dest_unavailable_lost": eng["dest_unavailable_lost"],
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_sparse_identity(device, target=10_000, warm_s=10.0, ticks=10):
    import torch
    from oversim_tpu_torch import tree
    t0 = time.perf_counter()
    warm = sparse_sim(target, device, "pallas", life=100.0)
    s0 = warm.run_until_device(warm.init(SEED), warm_s, chunk=CHUNK)

    def run(sim, state):
        return sim.run_chunk(tree.tree_map(lambda x: x.clone(), state),
                             ticks)

    kern = run(warm, s0)
    ops = run(sparse_sim(target, device, "scatter", life=100.0), s0)
    leaves_auto = compare_states(kern, ops)
    # sparse at a full cap vs dense needs slots that keep their nodeId on
    # rebirth: the dense tick re-sorts every sibling list by the current
    # keys each tick, the sparse tick only the awake nodes' lists, so a
    # sleeping node whose sibling slot is reborn under a fresh key keeps
    # the old order (the JAX package does the same; ROADMAP Queue C)
    rj = sparse_sim(target, device, "pallas", life=100.0, rejoin=True)
    s1 = rj.run_until_device(rj.init(SEED), warm_s, chunk=CHUNK)
    full = sparse_sim(target, device, "pallas", life=100.0, rejoin=True,
                      active_cap=warm.n)
    dense = sparse_sim(target, device, "pallas", life=100.0, rejoin=True,
                       tick_impl="dense")
    leaves_full = compare_states(strip_sparse(run(full, s1)),
                                 run(dense, strip_sparse(s1)))
    flips = int(torch.sum(kern.alive != s0.alive))
    rebirths = int(torch.sum(kern.churn.t_create != s0.churn.t_create))
    if flips == 0 or rebirths == 0:
        raise AssertionError("no churn fired inside the compared ticks")
    eng = warm.summary(kern)["_engine"]
    return {"phase": "sparse_identity", "n": warm.n, "acap": warm.acap,
            "t_start": float(s0.t_now) / 1e9, "ticks": ticks,
            "depth_cut": {"ticks": [50, ticks], "warm_s": [25.0, warm_s]},
            "leaves_kernels_vs_ops": leaves_auto,
            "leaves_full_cap_vs_dense": leaves_full,
            "alive_flips": flips, "create_schedule_changes": rebirths,
            "awake_nodes": eng["awake_nodes"],
            "active_deferred": eng["active_deferred"],
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_sparse_path(device, target=TGT_SPARSE):
    sim = sparse_sim(target, device, "pallas")
    s, base, out, warm_wall, wall, launches = run_window(
        sim, sim.init(SEED), device, SPARSE_KERNELS, warm_s=SPARSE_WARM_S,
        measure_s=MEASURE_S_UNCUT)
    line, healthy, finite = window_line("sparse_path", sim, base, out,
                                        warm_wall, wall, launches)
    eng, eng0 = out["_engine"], base["_engine"]
    ticks = line["ticks_measured"]
    line.update({
        "acap": sim.acap,
        "awake_share": (eng["awake_nodes"] - eng0["awake_nodes"])
        / max(ticks, 1) / sim.n,
        "active_dst_per_tick": (eng["active_dst"] - eng0["active_dst"])
        / max(ticks, 1),
        "active_deferred": eng["active_deferred"] - eng0["active_deferred"],
        "active_deferred_total": eng["active_deferred"]})
    line["depth_cut"] = {"warm_s": [WARM_S_UNCUT, SPARSE_WARM_S]}
    emit(line)
    if not healthy:
        raise AssertionError("sparse path failed the health gate")
    if out["_alive"] <= 0 or not finite:
        raise AssertionError("sparse path state is not as expected")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"sparse path never launched {missing}")
    s = sync_free_step(sim, s)
    emit({"phase": "sparse_path_sync_check", "host_syncs_in_tick": 0})
    return sim, s, launches


def max_f64_rel(a, b):
    """Largest relative difference over the float64 leaves of two states
    (the statistics' sums, whose order differs between the card and the
    CPU)."""
    import numpy as np
    fa, fb = flat_state(a), flat_state(b)
    worst = 0.0
    for k, x in fa.items():
        if x.dtype == np.float64 and x.size:
            y = fb[k]
            fin = np.isfinite(x) & np.isfinite(y)
            d = np.abs(x[fin] - y[fin]) / np.maximum(np.abs(x[fin]), 1e-300)
            worst = max(worst, float(d.max()) if d.size else 0.0)
    return worst


# float leaves within 1e-12 relative: the float64 statistics' sums run in
# another order on the card (torch.sum) than on the CPU (XLA-CPU's
# order); for the float32 leaves (Vivaldi coordinates, RTT estimates)
# that bound admits no difference at all, as each float32 operation
# rounds once on both devices
CHORD_RTOL = 1e-12


def phase_chord_reference(device, n=16, ticks=REF_TICKS["chord_reference"],
                          cpu=None):
    t0 = time.perf_counter()
    a = chord_sim(n, device, "pallas", deviation=0.0, jitter=0.0, inbox=8,
                  outbox=16)
    sa = a.run_chunk(a.init(SEED), ticks)
    sb = cpu_result(cpu, "chord_reference", n=n, ticks=ticks)["state"]
    leaves = compare_states(sa, sb, float_rtol=CHORD_RTOL)
    out = a.summary(sa)
    if out["kbr_delivered"] <= 0 or out["_alive"] != n:
        raise AssertionError(f"chord reference carried no traffic: {out}")
    if not bool((sa.logic.nc.rtt_mean > 0).any()):
        raise AssertionError("chord reference measured no RTT")
    return {"phase": "chord_reference", "n": n, "ticks": ticks,
            "depth_cut": {"ticks": [128, ticks]}, "leaves": leaves,
            "float_rtol": CHORD_RTOL,
            "float64_max_rel_diff": max_f64_rel(sa, sb),
            "kbr_sent": out["kbr_sent"], "kbr_delivered": out["kbr_delivered"],
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_chord_path(device, n):
    """The dense Chord path on the kernels.  Gate: no pool or outbox
    overflow, lookups delivered, every dense kernel launched; delivery
    is printed, not held to 0.95 (the reference's own Chord delivers
    0.71-0.79 at N=1,000 in this configuration, PERF.md)."""
    import math
    import torch
    sim = chord_sim(n, device, "pallas")
    torch.cuda.reset_peak_memory_stats(device)
    s, base, out, warm_wall, wall, launches = run_window(
        sim, sim.init(SEED), device, DENSE_KERNELS)
    line, _, finite = window_line("chord_path", sim, base, out, warm_wall,
                                  wall, launches)
    for k in ("kbr_lookup_failed", "lookup_failed", "lookup_success"):
        line[k] = out[k] - base[k]
    line["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    line["depth_cut"] = {"warm_s": [WARM_S_UNCUT, WARM_S],
                         "measure_s": [MEASURE_S_UNCUT, MEASURE_S]}
    emit(line)
    eng = out["_engine"]
    if (line["kbr_delivered"] <= 0 or eng["pool_overflow"]
            or eng["outbox_overflow"]):
        raise AssertionError("chord path failed its gate")
    if out["_alive"] != n or not finite or not math.isfinite(
            line["delivery"]):
        raise AssertionError("chord path state is not as expected")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"chord path never launched {missing}")
    s = sync_free_step(sim, s)
    emit({"phase": "chord_sync_check", "host_syncs_in_tick": 0})
    return sim, s, launches


def check_lex_argmin_ties(device, rows, c=168, seed=5):
    """Chord's ``_lex_argmin`` (``torch.argmin`` of the folded top two
    lanes) against element 0 of a stable sort of the same keys, on
    ``rows`` rows of ``c`` distances drawn from 4 values per lane (ties
    everywhere) and on all-UMAX rows; returns the rows checked."""
    import numpy as np
    import torch
    from oversim_tpu_torch.overlay import chord
    rng = np.random.default_rng(seed)
    d = torch.as_tensor(rng.integers(0, 4, (rows, c, 5)), device=device)
    d[: rows // 8, :, :2] = 0xFFFFFFFF
    want = torch.sort(chord._top_key(d), dim=-1, stable=True).indices[:, 0]
    if not torch.equal(chord._lex_argmin(d).long(), want):
        raise AssertionError("_lex_argmin differs from the stable sort")
    return rows


def phase_chord_identity(device, n, s0, ticks=5):
    """``ticks`` ticks from the warmed state ``s0`` with the torch-ops
    inbox and with the kernels: every leaf equal."""
    from oversim_tpu_torch import tree
    t0 = time.perf_counter()
    runs = []
    for impl in ("scatter", "pallas"):
        sim = chord_sim(n, device, impl)
        runs.append(sim.run_chunk(tree.tree_map(lambda x: x.clone(), s0),
                                  ticks))
    leaves = compare_states(*runs)
    ties = check_lex_argmin_ties(s0.alive.device, n)
    return {"phase": "chord_identity", "n": n, "ticks": ticks,
            "depth_cut": {"ticks": [50, ticks]},
            "t_start": float(s0.t_now) / 1e9, "leaves": leaves,
            "lex_argmin_tie_rows": ties,
            "pool_valid": int(runs[1].pool.valid.sum()),
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_chord_sparse_reference(
        device, ticks=REF_TICKS["chord_sparse_reference"], cpu=None):
    """The sparse tick under lifetime churn at 24 slots, card (kernels)
    against CPU (torch ops); the sparse kernels' launches are counted
    over the card run alone."""
    import torch
    from oversim_tpu_torch import kernels
    t0 = time.perf_counter()
    a = tiny_chord_sparse_sim(device, "pallas")
    kernels.reset_launches()
    sa = a.run_chunk(a.init(SEED), ticks)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = {k: kernels.LAUNCHES[k] for k in SPARSE_KERNELS}
    sb = cpu_result(cpu, "chord_sparse_reference", ticks=ticks)["state"]
    leaves = compare_states(sa, sb, float_rtol=CHORD_RTOL)
    out = a.summary(sa)
    eng = out["_engine"]
    if out["kbr_sent"] <= 0 or eng["dest_unavailable_lost"] <= 0:
        raise AssertionError(f"chord sparse reference saw no traffic or "
                             f"churn: {out}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"chord sparse run never launched {missing}")
    return {"phase": "chord_sparse_reference", "n": a.n, "ticks": ticks,
            "depth_cut": {"ticks": [128, ticks]},
            "leaves": leaves, "float_rtol": CHORD_RTOL,
            "float64_max_rel_diff": max_f64_rel(sa, sb),
            "kbr_sent": out["kbr_sent"],
            "kbr_delivered": out["kbr_delivered"], "alive": out["_alive"],
            "awake_nodes": eng["awake_nodes"],
            "dest_unavailable_lost": eng["dest_unavailable_lost"],
            "launches": launches,
            "seconds": round(time.perf_counter() - t0, 3)}, launches


DHT_HOOKS = ("put_sends", "get_sends", "handover_sends", "update_staged")


def check_dht_ties(device, rows, seed=9):
    """The DHT's first-index picks on the card against a stable sort on
    the CPU, on ``rows`` rows of tied inputs: ``_first_index`` of bool
    masks (storage hits, free slots, the update target; some rows all
    False), ``torch.argmin`` of storage expiries drawn from 3 values (the
    eviction column) and ``_vote_winner`` on votes from 4 values at every
    fill level; returns the rows checked."""
    import numpy as np
    import torch
    from oversim_tpu_torch.apps import dht
    rng = np.random.default_rng(seed)
    mask = torch.as_tensor(rng.random((rows, 32)) < 0.1)
    mask[: rows // 8] = False
    expire = torch.as_tensor(rng.integers(0, 3, (rows, 32)))
    votes = torch.as_tensor(rng.integers(-2, 2, (rows, 4)).astype(np.int32))
    acks = torch.as_tensor(rng.integers(0, 6, (rows,)).astype(np.int32))
    first = torch.sort((~mask).to(torch.int32), dim=-1,
                       stable=True).indices[:, 0]
    evict = torch.sort(expire, dim=-1, stable=True).indices[:, 0]
    app = dht.DhtApp(dht.DhtParams())
    want = app._vote_winner(votes, acks)
    got = app._vote_winner(votes.to(device), acks.to(device))
    if not (torch.equal(dht._first_index(mask.to(device)).cpu().long(), first)
            and torch.equal(torch.argmin(expire.to(device), -1).cpu(), evict)
            and all(torch.equal(g.cpu(), w) for g, w in zip(got, want))):
        raise AssertionError("the DHT's first-index picks differ on the card")
    return rows


def dht_card_half(ticks=REF_TICKS["dht_reference"], device=None):
    """The card half of ``dht_reference`` (its runs with the kernels and
    the tie check), in a child process beside the reference phases whose
    card work is compared, not timed (see ``pastry_card_half``).  Returns
    ({overlay: (flat state, hook tallies, summary fields, slots)},
    {kernel: launches}, tie rows, card seconds)."""
    from oversim_tpu_torch import interop, kernels
    device = _child_card(device)
    t0 = time.perf_counter()
    launches = dict.fromkeys(DENSE_KERNELS, 0)
    runs = {}
    for overlay in ("kad", "chord"):
        a = tiny_dht_sim(device, "pallas", overlay)
        kernels.reset_launches()
        sa = a.run_chunk(a.init(SEED), ticks)
        _sync(device)
        for k in DENSE_KERNELS:
            launches[k] += kernels.LAUNCHES[k]
        out = a.summary(sa)
        runs[overlay] = (
            interop.state_to_numpy(sa),
            {k: int(v) for k, v in a.logic.app.tally.items()},
            {k: out[k] for k in ("dht_mnt_puts", "dht_put_attempts",
                                 "dht_put_success", "dht_get_attempts",
                                 "dht_get_success", "dht_stored")}, a.n)
    ties = check_dht_ties(device, 10_000)
    return runs, launches, ties, time.perf_counter() - t0


def phase_dht_reference(device, ticks=REF_TICKS["dht_reference"], cpu=None,
                        card=None):
    """Kademlia + DHT and Chord + DHT at 16 slots, card (kernels; ``card``,
    the child process's ``dht_card_half``, or run here) against CPU
    (torch ops), each for ``ticks`` ticks; every hook of the DHT must
    have acted (Chord's urgent new-predecessor staging included).  The
    dense kernels' launches are counted over the card runs alone."""
    t0 = time.perf_counter()
    runs, launches, ties, card_s = (card.result() if card is not None
                                    else dht_card_half(ticks))
    line = {"phase": "dht_reference", "ticks": ticks,
            "depth_cut": {"ticks": [160, ticks]},
            "float_rtol": CHORD_RTOL, "card_s": round(card_s, 3),
            "card_in_child_process": card is not None}
    ref = cpu_result(cpu, "dht_reference", ticks=ticks)
    for overlay, (flat, hooks, out, n) in runs.items():
        sb = ref[overlay]
        leaves = compare_states(flat, sb, float_rtol=CHORD_RTOL)
        if hooks != ref[overlay + "_tally"]:
            raise AssertionError(f"dht {overlay}: hook tallies differ")
        hooks["dht_mnt_puts"] = out["dht_mnt_puts"]
        need = DHT_HOOKS + ("dht_mnt_puts",) + (
            ("update_urgent",) if overlay == "chord" else ())
        idle = [k for k in need if hooks.get(k, 0) <= 0]
        if idle:
            raise AssertionError(f"dht {overlay}: hooks never acted: {idle}")
        line[overlay] = {
            "n": n, "leaves": leaves,
            "float64_max_rel_diff": max_f64_rel(flat, sb), "hooks": hooks,
            **{k: out[k] for k in ("dht_put_attempts", "dht_put_success",
                                   "dht_get_attempts", "dht_get_success",
                                   "dht_stored")}}
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"dht reference never launched {missing}")
    line.update({"launches": launches, "tie_rows": ties,
                 "seconds": round(time.perf_counter() - t0, 3)})
    return line


def dht_window_line(sim, s, base, out, warm_wall, wall, launches):
    """The ``dht_path`` line's fields and its gate."""
    import torch
    d = {k: out[k] - base[k] for k in (
        "dht_put_attempts", "dht_put_success", "dht_get_attempts",
        "dht_get_success", "dht_get_wrong", "dht_get_notfound",
        "dht_mnt_puts", "dht_stored", "dht_lookup_failed")}
    ticks = out["_ticks"] - base["_ticks"]
    put_r = (d["dht_put_success"] / d["dht_put_attempts"]
             if d["dht_put_attempts"] else 0.0)
    get_r = (d["dht_get_success"] / d["dht_get_attempts"]
             if d["dht_get_attempts"] else 0.0)
    line = {"phase": "dht_path", "n": sim.n, "target": sim.cp.target_num,
            "inbox_impl": sim.ep.inbox_impl, "ticks": out["_ticks"],
            "ticks_measured": ticks, "window_s": [base["_t_sim"],
                                                  out["_t_sim"]],
            "alive": out["_alive"],
            "ring_cursor": int(s.logic.app_glob.cursor),
            "ring_slots": int(s.logic.app_glob.val.shape[0]), **d,
            "put_success_ratio": put_r, "get_success_ratio": get_r,
            "reference": DHT_REFERENCE, "bar": DHT_BAR,
            "dht_ops_per_s": (d["dht_put_success"] + d["dht_get_success"])
            / wall if wall > 0 else 0.0,
            "warm_wall_s": round(warm_wall, 3), "wall_s": round(wall, 3),
            "wall_ms_per_tick": wall * 1e3 / ticks if ticks else 0.0,
            "sim_s_per_wall_s": (out["_t_sim"] - base["_t_sim"]) / wall
            if wall > 0 else 0.0,
            "peak_memory_gb": torch.cuda.max_memory_allocated(
                s.alive.device) / 1e9,
            "engine": out["_engine"], "launches": launches}
    eng = out["_engine"]
    healthy = (eng["pool_overflow"] == 0 and eng["outbox_overflow"] == 0
               and d["dht_put_attempts"] > 0 and d["dht_get_attempts"] > 0
               and all(abs(line[k] - DHT_REFERENCE[k]) <= DHT_BAR
                       for k in DHT_REFERENCE))
    return line, healthy


def phase_dht_path(device, target=DHT_TARGET):
    """The DHT path on the dense kernels: warm-up to 100 s, a measured
    10 s window.  Returns (sim, state, line, healthy, launches); the
    caller adds ``dht_profile``'s device numbers before printing."""
    import torch
    sim = dht_sim(target, device, "pallas")
    torch.cuda.reset_peak_memory_stats(device)
    s, base, out, warm_wall, wall, launches = run_window(
        sim, sim.init(SEED), device, DENSE_KERNELS, warm_s=DHT_WARM_S,
        measure_s=MEASURE_S_UNCUT)
    line, healthy = dht_window_line(sim, s, base, out, warm_wall, wall,
                                    launches)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"dht path never launched {missing}")
    return sim, s, line, healthy, launches


def phase_dht_identity(device, target, s0, ticks=5):
    """``ticks`` ticks from the DHT path's state with the torch-ops inbox
    and with the kernels: every leaf equal."""
    from oversim_tpu_torch import tree
    t0 = time.perf_counter()
    runs = []
    for impl in ("scatter", "pallas"):
        sim = dht_sim(target, device, impl)
        runs.append(sim.run_chunk(tree.tree_map(lambda x: x.clone(), s0),
                                  ticks))
    leaves = compare_states(*runs)
    return {"phase": "dht_identity", "n": 2 * target, "ticks": ticks,
            "depth_cut": {"ticks": [50, ticks]},
            "t_start": float(s0.t_now) / 1e9, "leaves": leaves,
            "ring_cursor": int(runs[1].logic.app_glob.cursor),
            "pool_valid": int(runs[1].pool.valid.sum()),
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_dht_sparse_reference(
        device, ticks=REF_TICKS["dht_sparse_reference"], cpu=None):
    """Kademlia + DHT on the sparse tick at 24 slots, card (kernels)
    against CPU (torch ops); the sparse kernels' launches are counted
    over the card run alone."""
    import torch
    from oversim_tpu_torch import kernels
    t0 = time.perf_counter()
    a = tiny_dht_sim(device, "pallas", tick_impl="sparse", target=12)
    kernels.reset_launches()
    sa = a.run_chunk(a.init(SEED), ticks)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = {k: kernels.LAUNCHES[k] for k in SPARSE_KERNELS}
    sb = cpu_result(cpu, "dht_sparse_reference", ticks=ticks)["state"]
    leaves = compare_states(sa, sb, float_rtol=CHORD_RTOL)
    out = a.summary(sa)
    eng = out["_engine"]
    hooks = {k: int(v) for k, v in a.logic.app.tally.items()}
    if (hooks.get("put_sends", 0) <= 0 or out["dht_mnt_puts"] <= 0
            or eng["dest_unavailable_lost"] <= 0):
        raise AssertionError(f"dht sparse reference saw no puts, "
                             f"maintenance or churn: {out} {hooks}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"dht sparse run never launched {missing}")
    return {"phase": "dht_sparse_reference", "n": a.n, "ticks": ticks,
            "depth_cut": {"ticks": [128, ticks]},
            "leaves": leaves, "float_rtol": CHORD_RTOL,
            "float64_max_rel_diff": max_f64_rel(sa, sb), "hooks": hooks,
            "dht_mnt_puts": out["dht_mnt_puts"], "alive": out["_alive"],
            "awake_nodes": eng["awake_nodes"],
            "dest_unavailable_lost": eng["dest_unavailable_lost"],
            "launches": launches,
            "seconds": round(time.perf_counter() - t0, 3)}, launches


def clone_rows(rows):
    from oversim_tpu_torch import tree
    return [tree.tree_map(lambda x: x.clone(), r) for r in rows]


def campaign_card_half(ticks=REF_TICKS["campaign_reference"],
                       until_s=CAMP_UNTIL_S, sparse_ticks=CAMP_SPARSE_TICKS,
                       device=None):
    """The card half of ``campaign_reference`` in a child process (see
    ``dht_card_half``): the flat states of the three campaigns, the
    telemetry sample counts, the report's traffic and churn fields, the
    sparse kernels' launches and the card seconds."""
    from oversim_tpu_torch import interop, kernels, tree
    device = _child_card(device)
    t0 = time.perf_counter()
    ca = tiny_campaign(device, "pallas")
    ra = ca.run_chunk(ca.init(), ticks)
    ua = ca.run_until_device(ra, until_s, chunk=8)
    xa = tiny_campaign(device, "pallas", tick_impl="sparse")
    kernels.reset_launches()
    ya = xa.run_chunk(xa.init(), sparse_ticks)
    _sync(device)
    launches = {k: kernels.LAUNCHES[k] for k in SPARSE_KERNELS}
    rep = ca.report(ua)
    return {"chunk": interop.state_to_numpy(tree.stack(ra)),
            "until": interop.state_to_numpy(tree.stack(ua)),
            "sparse": interop.state_to_numpy(tree.stack(ya)),
            "tel_n": [int(r.telemetry.n) for r in ra],
            "kbr_sent": rep["kbr_sent"], "kbr_delivered": rep["kbr_delivered"],
            "campaign": rep["_campaign"], "s": ca.s, "grid": ca.grid,
            "n": ca.sim.n, "sparse_s": xa.s, "launches": launches,
            "card_s": time.perf_counter() - t0}


def phase_campaign_reference(device, ticks=REF_TICKS["campaign_reference"],
                             until_s=CAMP_UNTIL_S,
                             sparse_ticks=CAMP_SPARSE_TICKS, cpu=None,
                             card=None):
    """``tiny_campaign`` on the card (kernels; ``card``, the child
    process's ``campaign_card_half``, or run here) against the CPU (torch
    ops, held leaf-exact to the JAX package's campaign by
    tests/test_torch_campaign.py): ``ticks`` ticks of ``run_chunk``, then
    ``run_until_device`` to ``until_s`` (per-row time and tick equal),
    then a sparse-tick campaign of two rows for ``sparse_ticks`` ticks
    with the sparse kernels' launches counted over its card run.
    Integer leaves equal, float leaves within 1e-12 relative."""
    t0 = time.perf_counter()
    c = (card.result() if card is not None
         else campaign_card_half(ticks, until_s, sparse_ticks))
    ref = cpu_result(cpu, "campaign_reference", ticks=ticks, until_s=until_s,
                     sparse_ticks=sparse_ticks)
    leaves = compare_states(c["chunk"], ref["chunk"], float_rtol=CHORD_RTOL)
    tel_n = c["tel_n"]
    if tel_n != [ticks // 4] * c["s"]:
        raise AssertionError(f"campaign reference: telemetry samples {tel_n}")
    sa, sb = c["until"], ref["until"]
    t_a, t_b = sa[".t_now"].tolist(), sb[".t_now"].tolist()
    k_a, k_b = sa[".tick"].tolist(), sb[".tick"].tolist()
    if t_a != t_b or k_a != k_b or min(t_a) < until_s * 1e9:
        raise AssertionError(f"run_until_device rows differ: {t_a} {k_a} vs "
                             f"{t_b} {k_b}")
    leaves_until = compare_states(sa, sb, float_rtol=CHORD_RTOL)
    if c["kbr_sent"]["total"] <= 0 or \
            c["campaign"]["engine"]["dest_unavailable_lost"] <= 0:
        raise AssertionError(f"campaign reference saw no traffic or churn: "
                             f"{c['campaign']}")
    leaves_sparse = compare_states(c["sparse"], ref["sparse"],
                                   float_rtol=CHORD_RTOL)
    launches = c["launches"]
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"sparse campaign never launched {missing}")
    return {"phase": "campaign_reference", "n": c["n"], "s": c["s"],
            "grid": c["grid"], "ticks": ticks,
            "depth_cut": {"ticks": [64, ticks], "until_s": [10.0, until_s],
                          "sparse_ticks": [32, sparse_ticks]},
            "card_s": round(c["card_s"], 3),
            "card_in_child_process": card is not None,
            "leaves": leaves,
            "float_rtol": CHORD_RTOL, "telemetry_n": tel_n,
            "until_s": until_s, "t_now": t_a, "tick": k_a,
            "leaves_until": leaves_until,
            "kbr_sent": c["kbr_sent"]["per_replica"],
            "kbr_delivered": c["kbr_delivered"]["per_replica"],
            "sparse": {"s": c["sparse_s"], "ticks": sparse_ticks,
                       "leaves": leaves_sparse, "launches": launches},
            "seconds": round(time.perf_counter() - t0, 3)}, launches


def phase_campaign_path(device, target=CAMP_TARGET):
    """The campaign path on the dense kernels: every row warmed to
    CAMP_WARM_S by ``Campaign.run_until_device``, then a measured
    CAMP_MEASURE_S window, the launch counts set to 0 before the warm-up and read after
    the window.  Gate, per row: bench.py's health gate (delivery >= 0.95
    in the window, no pool or outbox overflow), finite statistics, one
    telemetry sample per 5 ticks with the ring wrapped; the report's
    delivery ratio over all rows with a finite CI; every dense kernel
    launched.  Returns (campaign, rows, line, launches)."""
    import math
    import torch
    from oversim_tpu_torch import kernels
    camp = campaign_of(campaign_sim(target, device, "pallas"))
    sim = camp.sim
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    kernels.reset_launches()
    cs = camp.run_until_device(camp.init(), CAMP_WARM_S, chunk=CHUNK)
    torch.cuda.synchronize(device)
    base = [sim.summary(r) for r in cs]
    warm_wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    cs = camp.run_until_device(cs, CAMP_WARM_S + CAMP_MEASURE_S, chunk=CHUNK)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t1
    launches = {k: kernels.LAUNCHES[k] for k in DENSE_KERNELS}
    outs = [sim.summary(r) for r in cs]
    rep = camp.report(cs)
    rows, bad = [], []
    for r, (b, o) in enumerate(zip(base, outs)):
        line, healthy, finite = window_line("campaign_path", sim, b, o,
                                            warm_wall, wall, launches)
        tel_n = int(cs[r].telemetry.n)
        wrapped = tel_n == o["_ticks"] // CAMP_TEL[0] and tel_n > CAMP_TEL[1]
        rows.append({"replica": camp.ids[r], "ov": camp.replica_ov(r),
                     **{k: line[k] for k in (
                         "t_sim", "alive", "ticks", "ticks_measured",
                         "kbr_sent", "kbr_delivered", "delivery",
                         "lookups_per_s", "lookup_hops_mean")},
                     "pool_overflow": o["_engine"]["pool_overflow"],
                     "outbox_overflow": o["_engine"]["outbox_overflow"],
                     "telemetry_n": tel_n, "ring_wrapped": wrapped})
        if not (healthy and finite and wrapped):
            bad.append(r)
    ticks = rows[0]["ticks_measured"]
    ratio, hops = rep["kbr_delivery_ratio"], rep["lookup_hops"]
    line = {"phase": "campaign_path", "s": camp.s, "n": sim.n,
            "target": target, "grid": camp.grid,
            "replicas": CAMP_REPLICAS, "base_seed": CAMP_SEED,
            "telemetry": {"sample_ticks": CAMP_TEL[0],
                          "window": CAMP_TEL[1]},
            "inbox_impl": sim.ep.inbox_impl,
            "depth_cut": {"warm_s": [WARM_S_UNCUT, CAMP_WARM_S],
                          "measure_s": [MEASURE_S_UNCUT, CAMP_MEASURE_S],
                          "telemetry_window": [CAMP_TEL_UNCUT,
                                               CAMP_TEL[1]]},
            "warm_wall_s": round(warm_wall, 3), "wall_s": round(wall, 3),
            "campaign_ticks_measured": ticks,
            "wall_ms_per_campaign_tick": wall * 1e3 / ticks if ticks else 0.0,
            "lookups_per_s_summed": sum(r["lookups_per_s"] for r in rows),
            "rows": rows,
            "kbr_delivery_ratio": {k: ratio[k] for k in (
                "k", "mean", "stddev", "ci", "confidence")},
            "lookup_hops": {k: hops[k] for k in (
                "k", "mean", "stddev", "ci", "confidence")},
            "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9,
            "launches": launches}
    emit(line)
    if bad:
        raise AssertionError(f"campaign rows {bad} failed the gate")
    if ratio["k"] != camp.s or not math.isfinite(ratio["ci"]):
        raise AssertionError("campaign report has no delivery CI")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"campaign path never launched {missing}")
    return camp, cs, line, launches


def campaign_sync_check(camp, cs):
    """One campaign tick with every host synchronisation an error."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cs = camp.run_chunk(cs, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return cs


def phase_campaign_identity(camp, cs, ticks=4):
    """``ticks`` campaign ticks from the path's rows ``cs`` against (a)
    the same ticks stepped solo for the first and last rows with their
    ``replica_ov``, (b) a campaign of those two rows (``replica_ids``, one
    per lifetime mean) on the torch-ops inbox and (c) one with telemetry
    off (the non-telemetry leaves): every leaf equal."""
    import dataclasses
    import torch
    from oversim_tpu_torch import tree
    t0 = time.perf_counter()
    sim = camp.sim
    ref = camp.run_chunk(clone_rows(cs), ticks)
    pick = (0, camp.s - 1)
    solo = {}
    for r in pick:
        row = sim.run_chunk(clone_rows([cs[r]])[0], ticks,
                            ov=camp.replica_ov(r))
        solo[r] = compare_states(row, ref[r])
    dev, target = sim.device, sim.cp.target_num
    start = clone_rows([cs[r] for r in pick])
    want = tree.stack([ref[r] for r in pick])
    sc = campaign_of(campaign_sim(target, dev, "scatter"), replica_ids=pick)
    leaves_scatter = compare_states(
        tree.stack(sc.run_chunk(clone_rows(start), ticks)), want)

    def strip(rows):
        return [dataclasses.replace(r, telemetry=None) for r in rows]

    off = campaign_of(campaign_sim(target, dev, "pallas", sample_ticks=0),
                      replica_ids=pick)
    leaves_off = compare_states(
        tree.stack(off.run_chunk(strip(start), ticks)),
        tree.stack(strip([ref[r] for r in pick])))
    flips = int(sum(torch.sum(a.alive != b.alive) for a, b in zip(ref, cs)))
    if flips == 0:
        raise AssertionError("no churn fired inside the compared ticks")
    return {"phase": "campaign_identity", "s": camp.s, "n": sim.n,
            "ticks": ticks, "depth_cut": {"ticks": [20, ticks]}, "t_start": [float(r.t_now) / 1e9 for r in cs],
            "rows_compared": list(pick),
            "leaves_solo_rows": solo, "leaves_scatter": leaves_scatter,
            "leaves_telemetry_off": leaves_off, "alive_flips": flips,
            "seconds": round(time.perf_counter() - t0, 3)}


# -- the service plane ----------------------------------------------------------

def _spans(trace, name):
    """[(args, start s, duration s)] of the ``name`` spans of a
    ``telemetry.PerfettoTrace``, in window order."""
    out = [(e.get("args", {}), e["ts"] / 1e6, e["dur"] / 1e6)
           for e in trace.events if e["name"] == name]
    return sorted(out, key=lambda x: (x[0].get("window", 0),
                                      x[0].get("windows_done", 0)))


def _ms(xs):
    return [round(x * 1e3, 3) for x in xs]


def loop_numbers(trace, wall, windows, every):
    """A ServiceLoop run's host numbers from its trace: per window the
    dispatch (``run_until_device``: issuing the window and waiting for
    its last chunk) and the fetch, the cycle from one dispatch start to
    the next, the gap between a dispatch's end and the next one's start
    (the host's drain of the window before, during which the card has
    nothing queued) split by whether that drain wrote a checkpoint, and
    each checkpoint's write time and bytes."""
    disp = _spans(trace, "window_dispatch")
    fetch = _spans(trace, "window_fetch")
    ck = _spans(trace, "checkpoint_write")
    gaps = [(b[0]["window"], b[1] - (a[1] + a[2]))
            for a, b in zip(disp, disp[1:])]
    # the gap before dispatch j holds the drain of window j - 2, which
    # wrote a checkpoint when (j - 1) % every == 0
    first = disp[0][0]["window"] if disp else 0

    def ck_drain(j):
        return j - 2 >= first and (j - 1) % every == 0

    ck_gap = [g for j, g in gaps if ck_drain(j)]
    plain_gap = [g for j, g in gaps if not ck_drain(j)]
    return {"wall_ms_per_window": wall * 1e3 / windows,
            "cycle_ms": _ms(b[1] - a[1] for a, b in zip(disp, disp[1:])),
            "dispatch_ms": _ms(d[2] for d in disp),
            "fetch_ms": _ms(f[2] for f in fetch),
            "gap_ms_checkpoint_drain": _ms(ck_gap),
            "gap_ms_other": _ms(plain_gap),
            "checkpoint_write_ms": _ms(c[2] for c in ck),
            "checkpoint_bytes": [c[0].get("bytes") for c in ck]}


def device_busy_ms(run):
    """(device busy ms, profiled wall s) of ``run()`` under torch.profiler
    with CUDA activity only: the kernels', memcpys' and memsets' device
    time summed ("not measured" when the profiler saw none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = sum(_dev_us(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return (busy if busy > 0 else "not measured"), wall, out


def phase_service_path(device, main_sim, s45):
    """The service plane on the main path's configuration, from its
    state at WARM_S: saved as a checkpoint of window 0; served
    uninterrupted for SVC_WINDOWS windows (double-buffered, a checkpoint
    every SVC_EVERY, every blocking host sync an error, the fetches
    counted); served by ``python -m oversim_tpu_torch.service --resume``
    in a child process that is SIGKILLed once its checkpoint says
    SVC_KILL_AT windows; resumed from that file to SVC_WINDOWS (writes
    on the launching thread, under the profiler).  Gate: the child died
    of the signal with no ``.tmp`` left, the resumed run equals the
    uninterrupted one in every leaf and in the summaries of the windows
    it served, the child's summaries equal too, another config hash is
    refused, one fetch per window."""
    import shutil
    import signal
    import subprocess
    import torch
    from oversim_tpu_torch import checkpoint as ckpt_mod
    from oversim_tpu_torch import kernels, telemetry, tree
    from oversim_tpu_torch.service import ServiceLoop, ServiceParams
    from oversim_tpu_torch.service import __main__ as cli
    t_phase = time.perf_counter()
    argv = service_argv(N_MAIN)
    args = cli.build_parser().parse_args(argv)
    sim = cli.build_sim(args)
    if not same_scenario(sim, main_sim):
        raise AssertionError("the service CLI's scenario is not the main "
                             "path's")
    cfg = cli.scenario_config(args)
    work = os.path.join(HERE, "build", "service_path")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    start, killed, whole_p, resumed_p = (
        os.path.join(work, f) for f in ("start.npz", "killed.npz",
                                        "whole.npz", "resumed.npz"))
    base = main_sim.summary(s45)
    start_t = base["_t_sim"]
    t0 = time.perf_counter()
    start_bytes = ckpt_mod.save(start, s45, meta={
        "config_hash": telemetry.config_hash(cfg),
        "service": {"windows_done": 0, "start_sim_t": start_t,
                    "window_sim_s": SVC_WINDOW_S, "chunk": SVC_CHUNK,
                    "checkpoint_every": SVC_EVERY}})
    save_ms = (time.perf_counter() - t0) * 1e3
    shutil.copy(start, killed)

    def params(path):
        return ServiceParams(window_sim_s=SVC_WINDOW_S, chunk=SVC_CHUNK,
                             checkpoint_every=SVC_EVERY, checkpoint_path=path)

    fetches = []

    def fetch(t):
        fetches.append(1)
        return tree.to_host(t)

    # uninterrupted, double-buffered, write-behind
    trace_u, sums_u = telemetry.PerfettoTrace("service_path"), []
    loop = ServiceLoop.resume(
        sim, sim.init(SEED), params(whole_p), path=start, config=cfg,
        trace=trace_u, fetch=fetch,
        on_window=lambda w, sm, t: sums_u.append(sm))
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        whole, done = loop.run(n_windows=SVC_WINDOWS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    wall_u = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in DENSE_KERNELS}
    peak = torch.cuda.max_memory_allocated(device)
    if done != SVC_WINDOWS or len(fetches) != SVC_WINDOWS:
        raise AssertionError(f"uninterrupted run: {done} windows, "
                             f"{len(fetches)} fetches")

    # the child: resumed from the copy, SIGKILLed at SVC_KILL_AT
    cmd = [sys.executable, "-m", "oversim_tpu_torch.service", "--resume",
           "--checkpoint", killed, "--checkpoint-every", str(SVC_EVERY),
           "--windows", str(SVC_WINDOWS), *argv]
    log_path = os.path.join(work, "child.log")
    seen, t_first = 0, None
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        child = subprocess.Popen(cmd, cwd=HERE, stdout=log,
                                 stderr=subprocess.STDOUT)
        try:
            while seen < SVC_KILL_AT:
                if child.poll() is not None:
                    raise AssertionError(
                        f"the service child exited ({child.returncode}) "
                        f"at checkpoint {seen}: "
                        + open(log_path).read()[-2000:])
                if time.perf_counter() - t0 > 600:
                    raise AssertionError("the service child made no "
                                         "checkpoint in 600 s")
                seen = ckpt_mod.read_meta(killed)["service"]["windows_done"]
                if seen and t_first is None:
                    t_first = time.perf_counter() - t0
                time.sleep(0.02)
            t_kill = time.perf_counter() - t0
            child.send_signal(signal.SIGKILL)
            rc = child.wait(timeout=60)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    child_recs = [json.loads(x) for x in open(log_path)
                  if x.startswith("{")]
    child_windows = [r for r in child_recs if "window" in r]
    tmp_left = os.path.exists(killed + ".tmp")
    if seen != SVC_KILL_AT or rc != -signal.SIGKILL or tmp_left:
        raise AssertionError(f"kill gate: checkpoint {seen}, return code "
                             f"{rc}, tmp left {tmp_left}")

    def strip(rec):
        return json.dumps({k: v for k, v in rec.items()
                           if k not in ("wall_s", "window")})

    child_equal = all(strip(r) == strip(sums_u[r["window"]])
                      for r in child_windows)

    # resumed from the killed child's checkpoint, profiled
    trace_r, sums_r = telemetry.PerfettoTrace("service_path"), []
    loop_r = ServiceLoop.resume(
        sim, sim.init(SEED), params(resumed_p), path=killed, config=cfg,
        trace=trace_r, write_behind=False,
        on_window=lambda w, sm, t: sums_r.append(sm))
    if loop_r.windows_done != SVC_KILL_AT:
        raise AssertionError(f"resumed at {loop_r.windows_done}")
    rest = SVC_WINDOWS - SVC_KILL_AT
    busy, wall_r, (resumed, _) = device_busy_ms(
        lambda: loop_r.run(n_windows=rest))
    leaves = compare_states(whole, resumed)
    summaries_equal = (json.dumps(sums_r) ==
                       json.dumps(sums_u[SVC_KILL_AT:]))
    try:
        ServiceLoop.resume(sim, sim.init(SEED), params(resumed_p),
                           path=killed, config=dict(cfg, seed=SEED + 1))
        refused = False
    except ValueError as e:
        refused = "scenario mismatch" in str(e)
    last = sums_u[-1]
    sent = last["kbr_sent"] - base["kbr_sent"]
    delivered = last["kbr_delivered"] - base["kbr_delivered"]
    num_u = loop_numbers(trace_u, wall_u, SVC_WINDOWS, SVC_EVERY)
    num_r = loop_numbers(trace_r, wall_r, rest, SVC_EVERY)
    wall_tail = sum(num_u["cycle_ms"][SVC_KILL_AT - 1:]) / 1e3
    line = {
        "phase": "service_path", "n": sim.n, "windows": SVC_WINDOWS,
        "window_sim_s": SVC_WINDOW_S, "chunk": SVC_CHUNK,
        "checkpoint_every": SVC_EVERY, "t_start": start_t,
        "t_end": last["_t_sim"], "ticks": last["_ticks"] - base["_ticks"],
        "start_checkpoint": {"bytes": start_bytes, "save_ms": save_ms},
        "uninterrupted": {"double_buffer": True, "write_behind": True,
                          "wall_s": wall_u, **num_u,
                          "fetches": len(fetches),
                          "blocking_host_syncs": 0},
        "killed_child": {"started_to_first_checkpoint_s": t_first,
                         "killed_at_s": t_kill, "killed_at_windows": seen,
                         "return_code": rc, "tmp_left": tmp_left,
                         "windows_reported": len(child_windows),
                         "summaries_equal": child_equal},
        "resumed": {"write_behind": False, "profiled": True,
                    "wall_s": wall_r, **num_r},
        "device_busy_ms_resumed_windows": busy,
        "device_idle_share": (1.0 - busy / (wall_tail * 1e3))
        if isinstance(busy, float) else "not measured",
        "device_idle_share_profiled": (1.0 - busy / (wall_r * 1e3))
        if isinstance(busy, float) else "not measured",
        "peak_memory_gb": peak / 1e9,
        "kbr_sent": sent, "kbr_delivered": delivered,
        "delivery": delivered / sent if sent else 0.0,
        "launches": launches,
        "launches_per_window": {k: v / SVC_WINDOWS
                                for k, v in launches.items()},
        "leaves": leaves, "summaries_5_8_equal": summaries_equal,
        "other_config_refused": refused,
        "engine": last["_engine"],
        "seconds": round(time.perf_counter() - t_phase, 3)}
    emit(line)
    shutil.rmtree(work, ignore_errors=True)
    if not (summaries_equal and child_equal and refused):
        raise AssertionError("service path: summaries, child windows or "
                             "config refusal gate failed")
    if delivered <= 0 or last["_engine"]["pool_overflow"] or \
            last["_engine"]["outbox_overflow"]:
        raise AssertionError("service path carried no traffic or overflowed")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"service path never launched {missing}")
    return launches


class PlannedIngest:
    """The ingest path's request source: before window k it submits
    ``plan[k]`` requests to an InProcessIngest (destinations uniform over
    the ``n`` slots from ``rng``, or two per node for a burst of 2 n),
    keeps each one's expected answer, and times the boundary work and the
    inject call site's ``alloc_dest`` launches; after each window it
    reads the pool's occupancy (outside the drain's time) and keeps a copy
    of the burst window's state before its drain."""

    def __init__(self, inner, plan, rng, n):
        self.inner, self.plan, self.rng, self.n = inner, plan, rng, n
        self.window = 0
        self.want = {}
        self.inject_ms, self.drain_ms, self.occupancy = [], [], []
        self.inject_launches = 0
        self.burst, self.burst_state = None, None

    def before_window(self, state, target_ns):
        import numpy as np
        from oversim_tpu_torch import kernels, tree
        k = self.window
        count = self.plan[k] if k < len(self.plan) else 0
        if count == 2 * self.n:
            dst = self.rng.permutation(np.repeat(np.arange(self.n), 2))
            self.burst = k
        else:
            dst = self.rng.integers(0, self.n, count)
        for d, c in zip(dst.tolist(),
                        self.rng.integers(0, 2 ** 30, count).tolist()):
            sid = self.inner.submit(b=k, c=c, dst=d)
            self.want[sid] = (k, c + INGEST_TRANSFORM)
        l0 = kernels.LAUNCHES["alloc_dest"]
        t0 = time.perf_counter()
        state = self.inner.before_window(state, target_ns)
        self.inject_ms.append((time.perf_counter() - t0) * 1e3)
        self.inject_launches += kernels.LAUNCHES["alloc_dest"] - l0
        self.window += 1
        return state

    def after_window(self, state):
        from oversim_tpu_torch import tree
        self.occupancy.append(int(state.pool.valid.sum()))
        if self.window - 1 == self.burst:
            # the burst window's pool, its answers parked, before the drain
            self.burst_state = tree.tree_map(lambda x: x.clone(), state)
        t0 = time.perf_counter()
        state = self.inner.after_window(state)
        self.drain_ms.append((time.perf_counter() - t0) * 1e3)
        return state


def gateway_round(sim, state):
    """GatewayIngest over a RealtimeGateway on the ingest path's state:
    GW_WINDOWS windows, each fed by GW_UDP datagrams from local UDP
    sockets and GW_TCP frames over local TCP connections, then windows
    without frames until every frame is answered (at most GW_QUIET_MAX:
    frames to the gateway node queue behind its other traffic, R a
    tick).  Returns (state, line)."""
    import socket
    import torch
    from oversim_tpu_torch.gateway import EXT_IN, EXT_OUT, _HDR, \
        RealtimeGateway
    from oversim_tpu_torch.service import (GatewayIngest, ServiceLoop,
                                           ServiceParams)
    t0 = time.perf_counter()
    t_start = int(state.t_now) / 1e9
    gw = RealtimeGateway(sim, state, gw_slot=0, tcp_port=0)
    per_window = []

    class Watched(GatewayIngest):
        """Counts each window's frames in, answers out and the EXT_IN
        still waiting in the pool (a read of the pool per window)."""

        def after_window(self, st):
            f0, a0 = gw.rx_frames, len(answered)
            pool = st.pool
            waiting = int(torch.sum(pool.valid & (pool.kind == EXT_IN)))
            backlog = int(torch.sum(pool.valid & (pool.dst == 0)
                                    & (pool.kind != EXT_OUT)
                                    & (pool.t_deliver < st.t_now)))
            st = super().after_window(st)
            per_window.append({"t_sim": int(st.t_now) / 1e9,
                               "frames_in": f0 - sum(
                                   w["frames_in"] for w in per_window),
                               "answers_out": len(answered) - a0,
                               "ext_in_waiting": waiting,
                               "gateway_node_backlog": backlog})
            return st

    answered = []
    encapsulate = gw.parser.encapsulate
    gw.parser.encapsulate = lambda sid, b, c: (answered.append(sid),
                                               encapsulate(sid, b, c))[1]
    loop = ServiceLoop(sim, state, ServiceParams(
        window_sim_s=SVC_WINDOW_S, chunk=SVC_CHUNK), ingest=Watched(gw))
    udp = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
           for _ in range(GW_UDP[0])]
    tcp = [socket.create_connection(("127.0.0.1", gw.tcp_port))
           for _ in range(GW_TCP[0])]
    for conn in tcp:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sent_udp, sent_tcp, serial = {}, {}, 0
    try:
        for _ in range(GW_WINDOWS):
            for i, u in enumerate(udp):
                for _ in range(GW_UDP[1]):
                    u.sendto(_HDR.pack(EXT_IN, 0, i, serial),
                             ("127.0.0.1", gw.udp_port))
                    sent_udp[(i, serial)] = serial + INGEST_TRANSFORM
                    serial += 1
            for i, conn in enumerate(tcp):
                frames = b""
                for _ in range(GW_TCP[1]):
                    frame = _HDR.pack(EXT_IN, 0, i, serial)
                    frames += len(frame).to_bytes(4, "big") + frame
                    sent_tcp[(i, serial)] = serial + INGEST_TRANSFORM
                    serial += 1
                conn.sendall(frames)
            time.sleep(0.02)
            loop.run(n_windows=1)
        quiet, total = 0, len(sent_udp) + len(sent_tcp)
        while len(answered) < total and quiet < GW_QUIET_MAX:
            loop.run(n_windows=1)
            quiet += 1
        state = loop.state
        got_udp, got_tcp = {}, {}
        for i, u in enumerate(udp):
            u.setblocking(False)
            while True:
                try:
                    data = u.recv(4096)
                except BlockingIOError:
                    break
                kind, _, b, c = _HDR.unpack_from(data)
                if kind == EXT_OUT:
                    got_udp[(b, c - INGEST_TRANSFORM)] = c
        for i, conn in enumerate(tcp):
            conn.settimeout(2.0)
            buf = b""
            want = GW_WINDOWS * GW_TCP[1] * (4 + _HDR.size)
            while len(buf) < want:
                try:
                    chunk = conn.recv(65536)
                except socket.timeout:
                    break
                if not chunk:
                    break
                buf += chunk
            for off in range(0, len(buf) - 3 - _HDR.size, 4 + _HDR.size):
                kind, _, b, c = _HDR.unpack_from(buf, off + 4)
                if kind == EXT_OUT:
                    got_tcp[(b, c - INGEST_TRANSFORM)] = c
    finally:
        for x in udp + tcp:
            x.close()
        gw.close()
    line = {"udp_sent": len(sent_udp), "udp_answered": sum(
                got_udp.get(k) == v for k, v in sent_udp.items()),
            "tcp_sent": len(sent_tcp), "tcp_answered": sum(
                got_tcp.get(k) == v for k, v in sent_tcp.items()),
            "rx_batches": gw.rx_batches, "rx_frames": gw.rx_frames,
            "rx_dropped": gw.rx_dropped, "rx_overflow": gw.rx_overflow(),
            "windows_with_frames": GW_WINDOWS, "quiet_windows": quiet,
            "t_start": t_start,
            "inbox_deferred": int(state.counters["inbox_deferred"]),
            "engine": {k: int(v) for k, v in state.counters.items()},
            "per_window": per_window,
            "seconds": round(time.perf_counter() - t0, 3)}
    return state, line


def phase_ingest_path(device):
    """Kademlia + the echo app at N_MAIN nodes warmed to INGEST_WARM_S,
    then INGEST_PLAN's windows served single-buffered through
    InProcessIngest (the launch counts set to 0 just before, read just
    after), then ``gateway_round``.  Gate: every request answered ``(b,
    c + INGEST_TRANSFORM)``, no NACK, no pool or outbox overflow, one
    pool write per window with requests; every datagram and frame
    answered, one pool write per window with frames.  Returns (line,
    launches, the burst window's state before its drain)."""
    import numpy as np
    import torch
    from oversim_tpu_torch import kernels, telemetry
    from oversim_tpu_torch.service import (InProcessIngest, ServiceLoop,
                                           ServiceParams)
    t_phase = time.perf_counter()
    sim = ingest_sim(N_MAIN, device, "pallas")
    t0 = time.perf_counter()
    s = sim.run_until_device(sim.init(SEED), INGEST_WARM_S, chunk=CHUNK)
    torch.cuda.synchronize(device)
    warm_wall = time.perf_counter() - t0
    inner = InProcessIngest(gw_slot=0)
    src = PlannedIngest(inner, INGEST_PLAN, np.random.default_rng(SEED),
                        N_MAIN)
    trace = telemetry.PerfettoTrace("ingest_path")
    loop = ServiceLoop(sim, s, ServiceParams(
        window_sim_s=SVC_WINDOW_S, chunk=SVC_CHUNK, double_buffer=False),
        ingest=src, trace=trace)
    kernels.reset_launches()
    t0 = time.perf_counter()
    s, done = loop.run(n_windows=len(INGEST_PLAN))
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in DENSE_KERNELS}
    exact = sum(inner.responses.get(sid) == w for sid, w in src.want.items())
    eng = {k: int(v) for k, v in s.counters.items()}
    overflow = inner.overflow()
    disp = _spans(trace, "window_dispatch")
    line = {"phase": "ingest_path", "n": sim.n, "ext_hold_slot": 0,
            "warm_s": INGEST_WARM_S, "warm_wall_s": warm_wall,
            "windows": done, "plan": list(INGEST_PLAN),
            "requests": len(src.want), "answered_exact": exact,
            "nacked": len(inner.nacked), "inject_overflow": overflow,
            "pool_writes": inner.num_batches,
            "windows_with_requests": sum(1 for x in INGEST_PLAN if x),
            "wall_s": wall,
            "answered_per_wall_s": exact / wall if wall > 0 else 0.0,
            "wall_ms_per_window": wall * 1e3 / done,
            "dispatch_ms": _ms(d[2] for d in disp),
            "inject_ms": [round(x, 3) for x in src.inject_ms],
            "drain_ms": [round(x, 3) for x in src.drain_ms],
            "pool_occupancy_max": max(src.occupancy),
            "pool_capacity": POOL_FACTOR * N_MAIN,
            "inbox_deferred": eng["inbox_deferred"], "engine": eng,
            "launches": launches,
            "inject_alloc_dest_launches": src.inject_launches}
    s, line["gateway"] = gateway_round(sim, s)
    line["seconds"] = round(time.perf_counter() - t_phase, 3)
    emit(line)
    gw = line["gateway"]
    if not (exact == len(src.want) == sum(INGEST_PLAN) and not inner.nacked
            and overflow == 0 and eng["pool_overflow"] == 0
            and eng["outbox_overflow"] == 0
            and inner.num_batches == line["windows_with_requests"]
            == src.inject_launches):
        raise AssertionError("ingest path failed its gate")
    if not (gw["udp_answered"] == gw["udp_sent"] == GW_WINDOWS * GW_UDP[0]
            * GW_UDP[1] and gw["tcp_answered"] == gw["tcp_sent"]
            == GW_WINDOWS * GW_TCP[0] * GW_TCP[1]
            and gw["rx_batches"] == GW_WINDOWS and gw["rx_dropped"] == 0
            and gw["rx_overflow"] == 0):
        raise AssertionError("gateway round failed its gate")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"ingest path never launched {missing}")
    return line, launches, src.burst_state


def phase_ingest_alloc_check(burst_state, device, repeats=REPEATS):
    """``alloc_dest`` at the inject call site, on the ingest path's pool
    after the burst window (its answers parked): batches of 1, 2,000 and
    2 N_MAIN, and 2,000
    into the pool with all but 1,000 of its free slots taken, each
    ``repeats`` times against its plain version and
    ``alloc_dest_cumsum``; and ``inject_ext_batch`` of the burst itself
    placing frame i in the plain version's slot i."""
    import torch
    from oversim_tpu_torch.engine import pool as pool_mod
    from oversim_tpu_torch.gateway import ExtFrame, inject_ext_batch
    t0 = time.perf_counter()
    valid = burst_state.pool.valid
    free = torch.nonzero(~valid).reshape(-1)
    full = valid.clone()
    full[free[1000:]] = True
    cases = [(f"q={q}", valid, q) for q in (1, 2000, 2 * N_MAIN)]
    cases.append(("nearly_full_q=2000", full, 2000))
    worst, out = 0, {}
    for what, v, q in cases:
        want = torch.ones((q,), dtype=torch.bool, device=device)
        worst = max(worst, check_alloc_case(what, v, want, device, repeats))
        out[what] = int(pool_mod.alloc_dest_cumsum(v, want)[1])
    q = 2 * N_MAIN
    frames = [ExtFrame(a=i + 1, b=0, c=i, dst=i % N_MAIN) for i in range(q)]
    st, over = inject_ext_batch(burst_state, frames, 0)
    dest, _ = pool_mod.alloc_dest_cumsum(valid, torch.ones(
        (q,), dtype=torch.bool, device=device))
    placed = st.pool.blk[dest.long(), pool_mod._COL["a"]]
    same = (bool(torch.equal(placed.cpu(), torch.arange(1, q + 1,
                                                        dtype=torch.int32)))
            and int(over) == 0 and bool(torch.equal(
                st.pool.valid, valid.index_fill(0, dest.long(), True))))
    if out["nearly_full_q=2000"] != 1000 or not same:
        raise AssertionError(f"inject placement check failed: {out} {same}")
    return {"phase": "ingest_alloc_check", "p": valid.shape[0],
            "free_after_burst": int(free.numel()), "cases": len(cases),
            "overflow": out, "repeats_per_case": repeats,
            "max_abs_err": worst, "inject_placement_equal": same,
            "tolerance": "exact",
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_service_reference(device, cpu=None):
    """``tiny_service_runners`` on the card: each served SVC_REF windows
    uninterrupted with a checkpoint every SVC_REF["every"]; the file at
    that first checkpoint (what a run abandoned there leaves) is resumed
    in a new loop to SVC_REF windows.  Gate: the resumed state equals the
    uninterrupted card run in every leaf, and the CPU run (torch ops,
    held leaf-exact to the JAX package by
    tests/test_torch_service_resume.py) with float leaves within 1e-12
    relative; KBRTest traffic seen."""
    import shutil
    import torch
    from oversim_tpu_torch import kernels, tree
    from oversim_tpu_torch.service import ServiceLoop, ServiceParams
    t0 = time.perf_counter()
    work = os.path.join(HERE, "build", "service_reference")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    windows, every = SVC_REF["windows"], SVC_REF["every"]
    runners = tiny_service_runners(device, "pallas")
    kernels.reset_launches()
    rows = {}
    for label, (runner, init, kw) in runners.items():
        path = os.path.join(work, f"{label}.npz")
        kept = os.path.join(work, f"{label}_at{every}.npz")
        cfg = {"reference": label}

        def keep(kind, windows_done=None, path=path, kept=kept, **_):
            if kind == "checkpoint_written" and windows_done == every:
                shutil.copy(path, kept)

        whole = serve(runner, init(), windows, every=every, path=path,
                      events=keep, config=cfg, **kw)
        params = ServiceParams(window_sim_s=SVC_REF["window_s"],
                               chunk=SVC_REF["chunk"])
        loop = ServiceLoop.resume(runner, init(), params, path=kept,
                                  config=cfg, **kw)
        if loop.windows_done != every:
            raise AssertionError(f"{label}: resumed at {loop.windows_done}")
        resumed, done = loop.run(n_windows=windows - every)
        if isinstance(whole, list):
            whole, resumed = tree.stack(whole), tree.stack(resumed)
        rows[label] = {"leaves_vs_uninterrupted": compare_states(whole,
                                                                 resumed),
                       "t_now": whole.t_now.cpu().tolist(),
                       "tick": whole.tick.cpu().tolist(),
                       "kbr_sent": int(whole.stats["c:kbr_sent"].sum()),
                       "dest_unavailable_lost": int(
                           whole.counters["dest_unavailable_lost"].sum())}
        rows[label]["_resumed"] = resumed
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = {k: kernels.LAUNCHES[k] for k in DENSE_KERNELS}
    ref = cpu_result(cpu, "service_reference", ticks=windows)
    for label, row in rows.items():
        row["leaves_vs_cpu"] = compare_states(row.pop("_resumed"),
                                              ref[label],
                                              float_rtol=CHORD_RTOL)
        if row["kbr_sent"] <= 0:
            raise AssertionError(f"service reference {label} saw no "
                                 f"traffic: {row}")
    shutil.rmtree(work, ignore_errors=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"service reference never launched {missing}")
    return {"phase": "service_reference", "windows": windows,
            "window_sim_s": SVC_REF["window_s"], "chunk": SVC_REF["chunk"],
            "resumed_from_window": every, "float_rtol": CHORD_RTOL,
            "runs": rows, "launches": launches,
            "seconds": round(time.perf_counter() - t0, 3)}


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device):
    import torch
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gb(device):
    """Peak device memory since the last ``_reset_peak`` (GB)."""
    import torch
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def ini_card_half(ticks=REF_TICKS["ini_reference"], device=None):
    """The card half of ``ini_reference``, in a process of its own (see
    ``pastry_card_half``).  Returns ({label: (flat state, summary
    fields)}, {kernel: launches}, card seconds)."""
    from oversim_tpu_torch import interop, kernels
    device = _child_card(device)
    t0 = time.perf_counter()
    kernels.reset_launches()
    out = {}
    for label in INI_REF:
        a = ini_ref_sim(label, device, "pallas")
        n_ticks = INI_TRACE_TICKS if INI_REF[label][2] else ticks
        sa = a.run_chunk(a.init(SEED), n_ticks)
        summ = a.summary(sa)
        out[label] = (interop.state_to_numpy(sa), {
            "n": a.n, "ticks": n_ticks, "churn": a.cp.model,
            "tick_impl": a.ep.tick_impl, "alive": summ["_alive"],
            "t_sim": summ["_t_sim"],
            "partition_lost": summ["_engine"]["partition_lost"]})
    _sync(device)
    return out, {k: kernels.LAUNCHES[k] for k in KERNELS}, \
        time.perf_counter() - t0


def phase_ini_reference(device, ticks=REF_TICKS["ini_reference"], cpu=None,
                        card=None):
    """``INI_REF``'s scenarios built from their ini texts (ParetoChurn,
    RandomChurn, pareto_shifted lifetimes, a trace-driven Kademlia + DHT
    with a partition, the sparse tick) on the card (kernels; ``card``,
    the child process's ``ini_card_half``, or run here) and on the CPU
    (torch ops): integer leaves equal, float leaves within 1e-12
    relative; the trace run's ``partition_lost`` > 0; all four kernels
    launched over the card runs."""
    t0 = time.perf_counter()
    runs, launches, card_s = (card.result() if card is not None
                              else ini_card_half(ticks, device))
    t1 = time.perf_counter()
    ref = cpu_result(cpu, "ini_reference", ticks=ticks)
    line = {"phase": "ini_reference", "float_rtol": CHORD_RTOL,
            "depth_cut": {"ticks": [96, ticks],
                          "trace_ticks": [320, INI_TRACE_TICKS]},
            "card_s": round(card_s, 3),
            "card_in_child_process": card is not None,
            "cpu_wait_s": round(time.perf_counter() - t1, 3),
            "launches": launches}
    for label, (flat, rec) in runs.items():
        rec["leaves"] = compare_states(flat, ref[label],
                                       float_rtol=CHORD_RTOL)
        line[label] = rec
    tr = line["trace_dht"]
    if tr["partition_lost"] <= 0:
        raise AssertionError(f"ini trace run lost nothing to its "
                             f"partition: {tr}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"ini reference never launched {missing}")
    line["seconds"] = round(time.perf_counter() - t0, 3)
    return line, launches


def phase_ini_identity(device, ticks=10):
    """The main path's scenario written as an ini (``main_ini``) and built
    by ``build_simulation`` with the main path's EngineParams, against
    ``bench_sim`` built by hand: the init state and ``ticks`` ticks, every
    leaf equal.  The ini has no key for two of the hand-built path's
    knobs, which are set on the built simulation: the lookup slots (8;
    ``LookupConfig`` defaults to 4) and the stagger's deviation (2 / N;
    ``ChurnParams`` defaults to 0.1)."""
    import dataclasses
    from oversim_tpu_torch.config.ini import IniFile
    from oversim_tpu_torch.config.scenario import build_simulation
    t0 = time.perf_counter()
    a = build_simulation(IniFile.loads(main_ini(N_MAIN)), "Main",
                         engine_params=main_engine_params(), device=device)
    a.logic.lcfg = dataclasses.replace(a.logic.lcfg, slots=8)
    a.cp = dataclasses.replace(a.cp, init_deviation=2.0 / N_MAIN)
    b = bench_sim(N_MAIN, device, "pallas")
    sa, sb = a.init(SEED), b.init(SEED)
    leaves_init = compare_states(sa, sb)
    sa, sb = a.run_chunk(sa, ticks), b.run_chunk(sb, ticks)
    leaves = compare_states(sa, sb)
    return {"phase": "ini_identity", "n": a.n, "ticks": ticks,
            "leaves_init": leaves_init, "leaves": leaves,
            "set_on_built_sim": {"lookup_slots": 8,
                                 "init_deviation": 2.0 / N_MAIN},
            "t_sim": float(sa.t_now) / 1e9,
            "seconds": round(time.perf_counter() - t0, 3)}


def _parse_vec_sca(vec_path, sca_path):
    """(vectors declared, rows, scalars) of an OMNeT++ .vec and .sca."""
    with open(vec_path) as f:
        vec = f.read().splitlines()
    with open(sca_path) as f:
        sca = f.read().splitlines()
    if vec[0] != "version 2" or not vec[1].startswith("run "):
        raise AssertionError(".vec header")
    decl = [x for x in vec if x.startswith("vector ")]
    rows = [x.split("\t") for x in vec[2:] if not x.startswith("vector ")]
    for r in rows:
        int(r[0]), float(r[1]), float(r[2])
    scal = {x.split()[2]: float(x.split()[3]) for x in sca
            if x.startswith("scalar ")}
    return len(decl), len(rows), scal


def phase_cli_path(device):
    """``python -m oversim_tpu_torch`` in-process on ``main_ini(N_MAIN)``
    with the ini's own engine defaults (window 0.01 s, 8 / 16 slots),
    ``--json``, ``--output-scalars`` and ``--output-vectors``, to
    CLI_UNTIL_S.  Gates: exit 0, the JSON record parses with ``sim.time``
    at least the horizon, the .sca and .vec parse, both dense kernels
    launched.  (The child run, ``cli_child_*``, overlaps ini_reference.)"""
    import contextlib
    import io
    from oversim_tpu_torch import kernels
    from oversim_tpu_torch.__main__ import main as cli_main
    t0 = time.perf_counter()
    os.makedirs(INI_DIR, exist_ok=True)
    ini = os.path.join(INI_DIR, "main.ini")
    with open(ini, "w") as f:
        f.write(main_ini(N_MAIN))
    vec, sca = (os.path.join(INI_DIR, f"cli.{x}") for x in ("vec", "sca"))
    _reset_peak(device)
    kernels.reset_launches()
    buf = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["-f", ini, "-c", "Main", "--until", str(CLI_UNTIL_S),
                       "--seed", str(SEED), "--json", "--output-scalars",
                       sca, "--output-vectors", vec, "--vector-interval",
                       "1"])
    _sync(device)
    wall = time.perf_counter() - t1
    launches = {k: kernels.LAUNCHES[k] for k in DENSE_KERNELS}
    rec = json.loads(buf.getvalue().splitlines()[-1])
    n_vec, n_rows, scal = _parse_vec_sca(vec, sca)
    line = {"phase": "cli_path", "n": N_MAIN, "rc": rc,
            "engine": "the ini's defaults: window 0.01 s, 8 inbox and 16 "
                      "outbox slots", "until_s": CLI_UNTIL_S,
            "sim_time": rec["_t_sim"], "ticks": rec["_ticks"],
            "alive": rec["_alive"], "kbr_sent": rec["kbr_sent"],
            "kbr_delivered": rec["kbr_delivered"],
            "engine_counters": rec["_engine"], "wall_s": round(wall, 3),
            "wall_ms_per_tick": wall * 1e3 / rec["_ticks"],
            "peak_memory_gb": _peak_gb(device),
            "vec_vectors": n_vec, "vec_rows": n_rows,
            "sca_scalars": len(scal), "launches": launches,
            "seconds": round(time.perf_counter() - t0, 3)}
    emit(line)
    if not (rc == 0 and rec["_t_sim"] >= CLI_UNTIL_S
            and scal.get("simTime", 0) >= CLI_UNTIL_S and n_rows > 0
            and all(v > 0 for v in launches.values())):
        raise AssertionError("cli path failed its gate")
    return launches


def cli_child_start():
    """Start ``python -m oversim_tpu_torch -f child.ini -c Main --until
    CLI_CHILD_UNTIL_S --json`` at CLI_CHILD_N (on the card) as a child
    process."""
    os.makedirs(INI_DIR, exist_ok=True)
    ini = os.path.join(INI_DIR, "child.ini")
    with open(ini, "w") as f:
        f.write(main_ini(CLI_CHILD_N))
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "oversim_tpu_torch", "-f", ini, "-c", "Main",
         "--until", str(CLI_CHILD_UNTIL_S), "--json"], cwd=HERE,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def cli_child_finish(started):
    """Wait for the child (stopping it if it outlives 300 s); gate: exit
    0 and ``sim.time`` of at least 2 s."""
    t0, proc = started
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    rec = json.loads(out.splitlines()[-1]) if proc.returncode == 0 else None
    emit({"phase": "cli_child", "n": CLI_CHILD_N, "rc": proc.returncode,
          "depth_cut": {"until_s": [2.0, CLI_CHILD_UNTIL_S]},
          "wall_s": round(time.perf_counter() - t0, 3),
          "sim_time": rec and rec["_t_sim"], "ticks": rec and rec["_ticks"],
          "stderr_tail": err[-400:] if proc.returncode else ""})
    if rec is None or rec["_t_sim"] < CLI_CHILD_UNTIL_S:
        raise AssertionError("the child CLI failed")


def phase_pareto_path(device):
    """BASELINE config 3's churn at full width: ``pareto_ini`` at
    PARETO_TARGET target nodes (3x slots) built by ``build_simulation``
    with the main path's EngineParams on the kernels, warmed to
    PARETO_WARM_S, a measured PARETO_MEASURE_S window.  Gate: no
    overflow, the alive count within 10% of the target, delivery >= 0.95
    or (where the reference's own delivery in that window at N=1,000 is
    lower) within PARETO_BAR of it.  Returns (sim, state, line, healthy,
    launches); the caller adds ``pareto_profile``'s device numbers
    before printing the line."""
    import torch
    from oversim_tpu_torch.config.ini import IniFile
    from oversim_tpu_torch.config.scenario import build_simulation
    sim = build_simulation(IniFile.loads(pareto_ini(PARETO_TARGET)),
                           "Pareto", engine_params=main_engine_params(),
                           device=device)
    _reset_peak(device)
    s, base, out, warm_wall, wall, launches = run_window(
        sim, sim.init(SEED), device, DENSE_KERNELS, warm_s=PARETO_WARM_S,
        measure_s=PARETO_MEASURE_S)
    line, healthy, finite = window_line("pareto_path", sim, base, out,
                                        warm_wall, wall, launches)
    ref = PARETO_REFERENCE["delivery"]
    bar_ok = line["delivery"] >= 0.95 or (
        ref is not None and ref < 0.95
        and abs(line["delivery"] - ref) <= PARETO_BAR)
    eng = out["_engine"]
    alive_ok = abs(out["_alive"] - PARETO_TARGET) <= 0.1 * PARETO_TARGET
    line.update({"target": PARETO_TARGET, "p": sim.ep.pool_factor * sim.n,
                 "q": sim.ep.outbox_slots * sim.n,
                 "alive_at_window_start": base["_alive"],
                 "reference": PARETO_REFERENCE, "bar": PARETO_BAR,
                 "peak_memory_gb": _peak_gb(device)})
    healthy = (eng["pool_overflow"] == 0 and eng["outbox_overflow"] == 0
               and alive_ok and bar_ok and line["kbr_sent"] > 0 and finite
               and all(v > 0 for v in launches.values()))
    return sim, s, line, healthy, launches


def _child_card(device):
    """The device of a card half run in a child process: the card (its
    kernels loaded from the parent's build) unless a CPU rehearsal passes
    one."""
    import torch
    from oversim_tpu_torch import kernels
    if device is not None:
        return device
    for name in kernels.SOURCES:
        kernels.library(name)
    return torch.device("cuda", 0)


def pastry_card_half(ticks=REF_TICKS["pastry_reference"], device=None):
    """The card half of ``pastry_reference``: ``PASTRY_REF``'s runs on the
    card with the kernels (built by the parent under build/kernels), in a
    process of its own beside the reference phases whose card work is
    compared, not timed.  Returns ({label: (flat state, summary fields)},
    {kernel: launches}, card seconds)."""
    from oversim_tpu_torch import interop, kernels
    device = _child_card(device)
    t0 = time.perf_counter()
    kernels.reset_launches()
    out = {}
    for label in PASTRY_REF:
        a = tiny_route_sim(label, device, "pallas")
        n_ticks = PASTRY_DHT_TICKS if label == "pastry_dht_ini" else ticks
        sa = a.run_chunk(a.init(SEED), n_ticks)
        summ = a.summary(sa)
        keep = {k: summ[k] for k in (
            "_alive", "_t_sim", "route_dropped", "kbr_sent", "kbr_delivered",
            "kbr_rpc_sent", "kbr_rpc_success", "dht_put_attempts",
            "dht_get_attempts") if k in summ}
        keep.update(n=a.n, ticks=n_ticks, overlay=type(a.logic).__name__,
                    tick_impl=a.ep.tick_impl,
                    partition_lost=summ["_engine"]["partition_lost"])
        out[label] = (interop.state_to_numpy(sa), keep)
    _sync(device)
    return out, {k: kernels.LAUNCHES[k] for k in KERNELS}, \
        time.perf_counter() - t0


def phase_pastry_reference(device, ticks=REF_TICKS["pastry_reference"],
                           cpu=None, card=None):
    """``PASTRY_REF``'s configurations on the card (kernels; ``card``, the
    child process's ``pastry_card_half``, or run here) against the CPU
    (torch ops): integer leaves equal, float leaves within 1e-12
    relative; traffic in every run; all four kernels launched."""
    t0 = time.perf_counter()
    runs, launches, card_s = (card.result() if card is not None
                              else pastry_card_half(ticks))
    t1 = time.perf_counter()
    ref = cpu_result(cpu, "pastry_reference", ticks=ticks)
    line = {"phase": "pastry_reference", "float_rtol": CHORD_RTOL,
            "card_s": round(card_s, 3),
            "card_in_child_process": card is not None,
            "cpu_wait_s": round(time.perf_counter() - t1, 3),
            "launches": launches}
    quiet = []
    for label, (flat, rec) in runs.items():
        rec["leaves"] = compare_states(flat, ref[label],
                                       float_rtol=CHORD_RTOL)
        if rec.get("kbr_delivered", 1) <= 0 or rec.get(
                "dht_put_attempts", 1) <= 0 or rec.get(
                "dht_get_attempts", 1) <= 0:
            quiet.append(label)
        line[label] = rec
    if quiet:
        raise AssertionError(f"pastry reference runs without traffic: "
                             f"{quiet}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"pastry reference never launched {missing}")
    line["seconds"] = round(time.perf_counter() - t0, 3)
    return line, launches


def pastry_sim(device, inbox_impl="pallas"):
    """``pastry_path``'s simulation: ``pastry_ini`` at PASTRY_TARGET
    through ``build_simulation`` with the main path's EngineParams."""
    from oversim_tpu_torch.config.ini import IniFile
    from oversim_tpu_torch.config.scenario import build_simulation
    return build_simulation(IniFile.loads(pastry_ini(PASTRY_TARGET)),
                            "Pastry", engine_params=main_engine_params(
                                inbox_impl), device=device)


def phase_pastry_path(device, keep=None):
    """BASELINE config 3's overlay and churn at full width (see the module
    docstring).  ``keep`` (a list) receives a copy of the state at the
    warm-up.  Returns (sim, state, line, healthy, launches); the caller
    adds ``pastry_profile``'s device numbers and the sync check."""
    from oversim_tpu_torch import tree
    sim = pastry_sim(device)
    _reset_peak(device)
    at_warm = None if keep is None else (
        lambda st: keep.append(tree.tree_map(lambda x: x.clone(), st)))
    s, base, out, warm_wall, wall, launches = run_window(
        sim, sim.init(SEED), device, DENSE_KERNELS, warm_s=PASTRY_WARM_S,
        at_warm=at_warm, measure_s=PASTRY_MEASURE_S)
    line, _, finite = window_line("pastry_path", sim, base, out, warm_wall,
                                  wall, launches)
    hops = out["kbr_hopcount"], base["kbr_hopcount"]
    n_h = hops[0]["count"] - hops[1]["count"]
    hop_mean = ((hops[0]["count"] * hops[0]["mean"]
                 - hops[1]["count"] * hops[1]["mean"]) / n_h if n_h else 0.0)
    ref = PASTRY_REFERENCE["delivery"]
    bar_ok = ref is not None and abs(line["delivery"] - ref) <= PASTRY_BAR
    eng = out["_engine"]
    line.update({
        "target": PASTRY_TARGET, "p": sim.ep.pool_factor * sim.n,
        "q": sim.ep.outbox_slots * sim.n,
        "depth_cut": {"target_nodes": [PASTRY_FULL_TARGET, PASTRY_TARGET]},
        "alive_at_window_start": base["_alive"],
        "hop_mean_window": hop_mean,
        "hop_hist_window": [a - b for a, b in zip(out["kbr_hop_hist"],
                                                   base["kbr_hop_hist"])],
        "route_dropped": out["route_dropped"] - base["route_dropped"],
        "kbr_wrong_node": out["kbr_wrong_node"] - base["kbr_wrong_node"],
        "pool_overflow": eng["pool_overflow"],
        "outbox_overflow": eng["outbox_overflow"],
        "reference": PASTRY_REFERENCE, "bar": PASTRY_BAR,
        "peak_memory_gb": _peak_gb(device)})
    healthy = (eng["pool_overflow"] == 0 and eng["outbox_overflow"] == 0
               and bar_ok and line["kbr_sent"] > 0 and finite
               and all(v > 0 for v in launches.values()))
    return sim, s, line, healthy, launches


def phase_pastry_identity(device, s0, ticks=5):
    """``ticks`` ticks from ``pastry_path``'s warmed state with the
    kernels and with the scatter inbox and plain allocation: every leaf
    equal."""
    from oversim_tpu_torch import tree
    t0 = time.perf_counter()
    a, b = pastry_sim(device, "scatter"), pastry_sim(device, "pallas")
    sa = a.run_chunk(tree.tree_map(lambda x: x.clone(), s0), ticks)
    sb = b.run_chunk(s0, ticks)
    leaves = compare_states(sa, sb)
    return {"phase": "pastry_identity", "n": a.n, "ticks": ticks,
            "depth_cut": {"ticks": [10, ticks]}, "t_sim": [float(s0.t_now) / 1e9, float(sa.t_now) / 1e9],
            "leaves": leaves, "alive": int(sa.alive.sum()),
            "seconds": round(time.perf_counter() - t0, 3)}


def db_card_half(overlay, device=None):
    """The card half of ``koorde_reference``, ``broose_reference``,
    ``epichord_reference`` or ``inet_reference``, in a process of its own
    (see ``pastry_card_half``).  Returns ({label: (flat state, summary
    fields)}, {kernel: launches}, card seconds); a run's ``delivered``
    is KBRTest's deliveries, or the DHT's successful puts and gets."""
    from oversim_tpu_torch import interop, kernels
    device = _child_card(device)
    ticks = REF_TICKS[f"{overlay}_reference"]
    t0 = time.perf_counter()
    kernels.reset_launches()
    out = {}
    for label in DB_REF[overlay]:
        a = tiny_lane_sim(label, device, "pallas")
        sa = a.run_chunk(a.init(SEED), ticks)
        summ = a.summary(sa)
        rec = {"n": a.n, "tick_impl": a.ep.tick_impl,
               "alive": summ["_alive"],
               "route_dropped": summ["route_dropped"],
               "parked_routes": int(sa.logic.rr.gen.sum())}
        if "kbr_sent" in summ:
            rec.update({k: summ[k] for k in (
                "kbr_sent", "kbr_delivered", "kbr_wrong_node")})
            rec["delivered"] = summ["kbr_delivered"]
        else:
            rec.update({k: summ[k] for k in (
                "dht_put_attempts", "dht_put_success", "dht_get_attempts",
                "dht_get_success")})
            rec["delivered"] = summ["dht_put_success"] + summ[
                "dht_get_success"]
        out[label] = (interop.state_to_numpy(sa), rec)
    _sync(device)
    return out, {k: kernels.LAUNCHES[k] for k in KERNELS}, \
        time.perf_counter() - t0


def phase_db_reference(device, overlay, cpu=None, card=None):
    """``DB_REF``'s runs of ``overlay`` on the card (kernels; ``card``,
    the child process's ``db_card_half``, or run here) against the CPU
    (torch ops, held leaf-exact to the JAX package by
    tests/test_torch_koorde.py, test_torch_broose.py,
    test_torch_epichord.py and test_torch_inet.py): integer leaves
    equal, float leaves within 1e-12 relative; deliveries in every run;
    the kernels of its ticks launched (all four where a run is sparse,
    the dense two otherwise)."""
    name = f"{overlay}_reference"
    ticks = REF_TICKS[name]
    t0 = time.perf_counter()
    runs, launches, card_s = (card.result() if card is not None
                              else db_card_half(overlay, device))
    t1 = time.perf_counter()
    ref = cpu_result(cpu, name)
    line = {"phase": name, "ticks": ticks, "float_rtol": CHORD_RTOL,
            "card_s": round(card_s, 3),
            "card_in_child_process": card is not None,
            "cpu_wait_s": round(time.perf_counter() - t1, 3),
            "launches": launches}
    quiet = []
    for label, (flat, rec) in runs.items():
        rec["leaves"] = compare_states(flat, ref[label],
                                       float_rtol=CHORD_RTOL)
        line[label] = rec
        if rec["delivered"] <= 0:
            quiet.append(label)
    if quiet:
        raise AssertionError(f"{name} runs without deliveries: {quiet}")
    sparse = any(rec["tick_impl"] == "sparse" for _, rec in runs.values())
    missing = [k for k, v in launches.items() if v <= 0
               and (sparse or k in DENSE_KERNELS)]
    if missing:
        raise AssertionError(f"{name} never launched {missing}")
    line["seconds"] = round(time.perf_counter() - t0, 3)
    return line, launches


def phase_db_path(device, overlay, keep=None):
    """``koorde_path``, ``broose_path``, ``epichord_path`` or
    ``inet_path`` (see the module docstring).  ``keep`` (a list) receives
    a copy of the warmed state.  Returns (sim, state, line, healthy,
    launches); the caller adds the profile's device numbers and the sync
    check."""
    from oversim_tpu_torch import tree
    from oversim_tpu_torch.overlay import broose, chord, epichord
    sim = lane_sim(overlay, device, "pallas")
    _reset_peak(device)
    at_warm = None if keep is None else (
        lambda st: keep.append(tree.tree_map(lambda x: x.clone(), st)))
    s, base, out, warm_wall, wall, launches = run_window(
        sim, sim.init(SEED), device, DENSE_KERNELS,
        warm_s=DB_WARM_S[overlay], at_warm=at_warm, measure_s=DB_MEASURE_S)
    line, _, finite = window_line(f"{overlay}_path", sim, base, out,
                                  warm_wall, wall, launches)
    hops = out["kbr_hopcount"], base["kbr_hopcount"]
    n_h = hops[0]["count"] - hops[1]["count"]
    eng = out["_engine"]
    ref = DB_REFERENCE[overlay]
    wrong = out["kbr_wrong_node"] - base["kbr_wrong_node"]
    wrong_share = wrong / line["kbr_delivered"] if line[
        "kbr_delivered"] else 0.0
    wrong_bar = None if "wrong_node" not in ref else (
        DB_WRONG_K * ref["wrong_node"] / ref["delivered"] + DB_WRONG_FLOOR)
    line.update({
        "hop_mean_window": ((hops[0]["count"] * hops[0]["mean"]
                             - hops[1]["count"] * hops[1]["mean"]) / n_h
                            if n_h else 0.0),
        "hop_hist_window": [a - b for a, b in zip(out["kbr_hop_hist"],
                                                   base["kbr_hop_hist"])],
        "kbr_wrong_node": wrong, "wrong_node_share": wrong_share,
        "lookup_failed": out.get("lookup_failed", 0)
        - base.get("lookup_failed", 0),
        "kbr_lookup_failed": out["kbr_lookup_failed"]
        - base["kbr_lookup_failed"],
        "pool_overflow": eng["pool_overflow"],
        "outbox_overflow": eng["outbox_overflow"],
        "warm_s": DB_WARM_S[overlay], "reference": ref, "bar": DB_BAR,
        "wrong_node_bar": wrong_bar, "peak_memory_gb": _peak_gb(device)})
    st = s.logic
    if overlay == "koorde":
        ready = st.state == chord.READY
        line["db_pointer_set_share_of_ready"] = float(
            (ready & (st.db_node >= 0)).sum()) / max(1, int(ready.sum()))
    elif overlay == "broose":
        line["join_states"] = {
            k: int((s.alive & (st.state == v)).sum()) for k, v in (
                ("init", broose.INIT), ("rset", broose.RSET),
                ("bset", broose.BSET), ("ready", broose.READY))}
        line["join_retries"] = out["broose_join_retries"]
    elif overlay == "epichord":
        ready = s.alive & (st.state == epichord.READY)
        n_ready = int(ready.sum())
        line["ready_share"] = n_ready / max(1, int(s.alive.sum()))
        line["cache_live_per_ready"] = float(
            ((st.cache >= 0) & ready[:, None]).sum()) / max(1, n_ready)
        line["slice_lookups"] = out["epi_slice_lookups"] - base[
            "epi_slice_lookups"]
    else:
        lat = out["kbr_latency_s"], base["kbr_latency_s"]
        n_l = lat[0]["count"] - lat[1]["count"]
        line["latency_mean_window_s"] = (
            (lat[0]["count"] * lat[0]["mean"]
             - lat[1]["count"] * lat[1]["mean"]) / n_l if n_l else 0.0)
        line["routers"] = INET_ROUTERS
    bar_ok = ref["delivered"] is not None and abs(
        line["delivery"] - ref["delivered"] / ref["sent"]) <= DB_BAR and (
        wrong_bar is None or wrong_share <= wrong_bar)
    healthy = (eng["pool_overflow"] == 0 and eng["outbox_overflow"] == 0
               and line["kbr_sent"] > 0 and line["kbr_delivered"] > 0
               and bar_ok and finite
               and all(v > 0 for v in launches.values()))
    return sim, s, line, healthy, launches


def phase_db_identity(device, overlay, s0, ticks=5):
    """``ticks`` ticks from the path's warmed state with the kernels and
    with the scatter inbox and plain allocation: every leaf equal."""
    from oversim_tpu_torch import tree
    t0 = time.perf_counter()
    a = lane_sim(overlay, device, "scatter")
    b = lane_sim(overlay, device, "pallas")
    sa = a.run_chunk(tree.tree_map(lambda x: x.clone(), s0), ticks)
    sb = b.run_chunk(s0, ticks)
    leaves = compare_states(sa, sb)
    return {"phase": f"{overlay}_identity", "n": a.n, "ticks": ticks,
            "t_sim": [float(s0.t_now) / 1e9, float(sa.t_now) / 1e9],
            "leaves": leaves, "alive": int(sa.alive.sum()),
            "pool_valid": int(sa.pool.valid.sum()),
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_epichord_fast_identity(device, n=DB_TARGET, ticks=EPI_FAST_TICKS,
                                 warm_s=EPI_FAST_WARM_S):
    """``epichord_fast_identity`` (see the module docstring).  A slice
    lookup counts where a lookup slot holds a P_SLICE lookup with a new
    start time; an entry counts as expired where it was past its TTL at
    its READY node's cache flush in the tick and is gone after it."""
    import torch
    from oversim_tpu_torch import tree
    from oversim_tpu_torch.overlay import epichord
    t0 = time.perf_counter()
    params = epichord.EpiChordParams(**{k: EPI_FAST[k]
                                        for k in EPI_FAST_TIMERS})
    a = db_sim("epichord", n, device, "scatter", epi_params=params)
    b = db_sim("epichord", n, device, "pallas", epi_params=params)
    s0 = b.run_chunk(b.init(SEED), round(warm_s / b.ep.window))
    sa = a.run_chunk(tree.tree_map(lambda x: x.clone(), s0), ticks)
    ttl = int(params.cache_ttl * epichord.NS)
    flush = int(params.cache_flush_delay * epichord.NS)
    sb, slices, expired = s0, 0, 0
    for _ in range(ticks):
        x = tree.tree_map(lambda v: v.clone(), sb.logic)
        sb = b.run_chunk(sb, 1)
        y = sb.logic
        slices += int((y.lk.active & (y.lk.purpose == epichord.P_SLICE) & (
            ~x.lk.active | (x.lk.t0 != y.lk.t0))).sum())
        flushed = (x.state == epichord.READY) & (
            y.state == epichord.READY) & (x.t_cache != y.t_cache)
        stale = flushed[:, None] & (x.cache >= 0) & (
            x.cache_seen + ttl < (y.t_cache - flush)[:, None])
        gone = ~torch.any(x.cache[:, :, None] == y.cache[:, None, :], -1)
        expired += int((stale & gone).sum())
    leaves = compare_states(sa, sb)
    line = {"phase": "epichord_fast_identity", "n": a.n, "ticks": ticks,
            "timers": {k: EPI_FAST[k] for k in EPI_FAST_TIMERS},
            "t_sim": [float(s0.t_now) / 1e9, float(sa.t_now) / 1e9],
            "leaves": leaves, "slice_lookups": slices,
            "cache_expired": expired,
            "ready": int((sb.alive & (sb.logic.state == epichord.READY))
                         .sum()),
            "seconds": round(time.perf_counter() - t0, 3)}
    if slices <= 0 or expired <= 0:
        raise AssertionError(f"epichord_fast_identity ran no slice lookup "
                             f"or cache expiry: {line}")
    return line


def game_record(sim, state):
    """A GIA, Vast or Quon run's counters for a reference line."""
    from oversim_tpu_torch.overlay.gia import GiaLogic
    summ = sim.summary(state)
    gia = isinstance(sim.logic, GiaLogic)
    x = "gia" if gia else sim.logic.PREFIX
    names = (("gia_joins", "gia_searches", "gia_search_success",
              "gia_search_failed", "gia_query_drops") if gia else
             tuple(f"{x}_{k}" for k in ("joins", "moves", "updates",
                                         "hints", "join_fwd")))
    rec = {"n": sim.n, "tick_impl": sim.ep.tick_impl,
           "alive": summ["_alive"], "t_sim": summ["_t_sim"],
           "pool_valid": int(state.pool.valid.sum()),
           "neighbors": int((state.logic.nbr >= 0).sum())}
    rec.update({k: summ[k] for k in names})
    rec["active"] = (summ["gia_searches"] if gia
                     else summ[f"{x}_updates"])
    return rec


def game_card_half(kind, device=None):
    """The card half of ``gia_reference`` or ``vast_reference`` in a
    process of its own (see ``pastry_card_half``): ({label: (flat state,
    counters)}, {kernel: launches}, card seconds)."""
    from oversim_tpu_torch import interop, kernels
    device = _child_card(device)
    ticks = REF_TICKS[f"{kind}_reference"]
    t0 = time.perf_counter()
    kernels.reset_launches()
    out = {}
    for label in GAME_REF[kind]:
        a = tiny_game_sim(label, device, "pallas")
        sa = a.run_chunk(a.init(SEED), ticks)
        out[label] = (interop.state_to_numpy(sa), game_record(a, sa))
    _sync(device)
    return out, {k: kernels.LAUNCHES[k] for k in KERNELS}, \
        time.perf_counter() - t0


def phase_game_reference(device, kind, cpu=None, card=None):
    """``GAME_REF[kind]``'s runs on the card (kernels; ``card``, the child
    process's ``game_card_half``, or run here) against the CPU (torch
    ops, held leaf-exact to the JAX package by tests/test_torch_gia.py
    and test_torch_vast.py): integer leaves equal, float leaves within
    1e-12 relative; searches (GIA) or position updates (Vast, Quon) in
    every run; all four kernels launched (each kind has a sparse run)."""
    name = f"{kind}_reference"
    ticks = REF_TICKS[name]
    t0 = time.perf_counter()
    runs, launches, card_s = (card.result() if card is not None
                              else game_card_half(kind, device))
    t1 = time.perf_counter()
    ref = cpu_result(cpu, name)
    line = {"phase": name, "ticks": ticks, "float_rtol": CHORD_RTOL,
            "card_s": round(card_s, 3),
            "card_in_child_process": card is not None,
            "cpu_wait_s": round(time.perf_counter() - t1, 3),
            "launches": launches}
    quiet = []
    for label, (flat, rec) in runs.items():
        rec["leaves"] = compare_states(flat, ref[label],
                                       float_rtol=CHORD_RTOL)
        line[label] = rec
        if rec["active"] <= 0:
            quiet.append(label)
    if quiet:
        raise AssertionError(f"{name} runs without traffic: {quiet}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"{name} never launched {missing}")
    line["seconds"] = round(time.perf_counter() - t0, 3)
    return line, launches


def window_mean(out, base, name):
    """A scalar statistic's mean over the window between two summaries."""
    a, b = out[name], base[name]
    n = a["count"] - b["count"]
    return (a["count"] * a["mean"] - b["count"] * b["mean"]) / n if n \
        else 0.0


def phase_gia_path(device, keep=None):
    """``gia_path`` (see the module docstring).  ``keep`` (a list)
    receives a copy of the warmed state.  Returns (sim, state, line,
    healthy, launches)."""
    import dataclasses
    import math
    from oversim_tpu_torch import tree
    from oversim_tpu_torch.overlay import gia
    sim = game_sim(game_logic("gia"), GIA_TARGET, device, "pallas")
    p = sim.logic.p
    _reset_peak(device)
    at_warm = None if keep is None else (
        lambda st: keep.append(tree.tree_map(lambda x: x.clone(), st)))
    s, base, out, warm_wall, wall, launches = run_window(
        sim, sim.init(SEED), device, DENSE_KERNELS, warm_s=GIA_WARM_S,
        at_warm=at_warm, measure_s=GIA_MEASURE_S)

    def d(k):
        return out[k] - base[k]

    st = s.logic
    ready = s.alive & (st.state == gia.READY)
    n_ready = int(ready.sum())
    deg = (st.nbr >= 0).sum(1)
    sat = sim.logic._satisfaction(st)
    searches, succ = d("gia_searches"), d("gia_search_success")
    ticks = out["_ticks"] - base["_ticks"]
    bound = (p.search_ttl + 1) * (p.max_neighbors + 1) / max(1, n_ready - 1)
    hop_mean = window_mean(out, base, "gia_search_hops")
    lat_mean = window_mean(out, base, "gia_search_latency_s")
    eng = out["_engine"]
    line = {"phase": "gia_path", "n": sim.n, "inbox_impl": sim.ep.inbox_impl,
            "window_s": [base["_t_sim"], out["_t_sim"]],
            "ticks": out["_ticks"], "ticks_measured": ticks,
            "alive": out["_alive"], "warm_wall_s": round(warm_wall, 3),
            "wall_s": round(wall, 3),
            "wall_ms_per_tick": wall * 1e3 / ticks if ticks else 0.0,
            "sim_s_per_wall_s": (out["_t_sim"] - base["_t_sim"]) / wall
            if wall > 0 else 0.0,
            "searches": searches, "search_success": succ,
            "search_failed": d("gia_search_failed"),
            "query_drops": d("gia_query_drops"),
            "success_ratio": succ / searches if searches else 0.0,
            "success_ratio_bound": bound,
            "searches_per_wall_s": searches / wall if wall > 0 else 0.0,
            "hop_mean_window": hop_mean,
            "latency_mean_window_s": lat_mean,
            "ready_share": n_ready / max(1, int(s.alive.sum())),
            "degree_mean_ready": float(deg[ready].float().mean())
            if n_ready else 0.0,
            "satisfaction_mean_ready": float(sat[ready].double().mean())
            if n_ready else 0.0,
            "tokens_held_mean_ready": float(
                st.tokens.sum(1)[ready].double().mean()) if n_ready else 0.0,
            "engine": eng, "launches": launches,
            "peak_memory_gb": _peak_gb(device),
            "params": dataclasses.asdict(p)}
    healthy = (eng["pool_overflow"] == 0 and eng["outbox_overflow"] == 0
               and line["ready_share"] >= 0.99
               and line["degree_mean_ready"] >= p.min_neighbors
               and searches > 0 and succ > 0 and succ / searches <= bound
               and hop_mean <= p.search_ttl + 1
               and math.isfinite(lat_mean)
               and all(v > 0 for v in launches.values()))
    return sim, s, line, healthy, launches


def phase_gia_identity(device, s0, ticks=5):
    """``ticks`` ticks from ``gia_path``'s warmed state with the kernels
    and with the scatter inbox and plain allocation: every leaf equal."""
    from oversim_tpu_torch import tree
    t0 = time.perf_counter()
    a = game_sim(game_logic("gia"), GIA_TARGET, device, "scatter")
    b = game_sim(game_logic("gia"), GIA_TARGET, device, "pallas")
    sa = a.run_chunk(tree.tree_map(lambda x: x.clone(), s0), ticks)
    sb = b.run_chunk(s0, ticks)
    return {"phase": "gia_identity", "n": a.n, "ticks": ticks,
            "t_sim": [float(s0.t_now) / 1e9, float(sa.t_now) / 1e9],
            "leaves": compare_states(sa, sb), "alive": int(sa.alive.sum()),
            "pool_valid": int(sa.pool.valid.sum()),
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_vast_identity(device, n=VAST_TARGET, warm_s=VAST_WARM_S,
                        ticks=VAST_TICKS):
    """``vast_identity`` (see the module docstring).  A kind counts where
    a message of it was in the pool before a compared tick and due
    inside it."""
    from oversim_tpu_torch import tree
    from oversim_tpu_torch.overlay.vast import (READY, V_HELLO, V_HINT,
                                                V_JOIN, V_MOVE)
    kinds = {"join": V_JOIN, "move": V_MOVE, "hint": V_HINT,
             "hello": V_HELLO}
    t0 = time.perf_counter()
    line = {"phase": "vast_identity", "n": n, "ticks": ticks,
            "warm_s": warm_s}
    for overlay in ("vast", "quon"):
        a = game_sim(game_logic(overlay), n, device, "scatter")
        b = game_sim(game_logic(overlay), n, device, "pallas")
        s0 = b.run_chunk(b.init(SEED), round(warm_s / b.ep.window))
        sa = a.run_chunk(tree.tree_map(lambda x: x.clone(), s0), ticks)
        sb, seen = due_kinds(b, s0, ticks, kinds)
        line[overlay] = {
            "t_sim": [float(s0.t_now) / 1e9, float(sa.t_now) / 1e9],
            "leaves": compare_states(sa, sb), "due": seen,
            "ready": int((sb.logic.state == READY).sum())}
        if min(seen.values()) <= 0:
            raise AssertionError(f"vast_identity: {overlay} lacks a message "
                                 f"kind in its ticks: {seen}")
    line["seconds"] = round(time.perf_counter() - t0, 3)
    return line


def phase_nice_path(device):
    """``nice_path`` (see the module docstring).  Returns (sim, state,
    line, healthy, launches)."""
    import dataclasses
    from oversim_tpu_torch.overlay import nice
    sim = nice_sim(NICE_TARGET, device, "pallas")
    _reset_peak(device)
    s, base, out, warm_wall, wall, launches = run_window(
        sim, sim.init(SEED), device, DENSE_KERNELS, warm_s=NICE_WARM_S,
        measure_s=NICE_MEASURE_S, chunk=round(1.0 / NICE_WINDOW))

    def d(k):
        return out[k] - base[k]

    ready = s.alive & (s.logic.state == nice.READY)
    n_ready = int(ready.sum())
    pub, recv, dup = d("nice_pub"), d("nice_recv"), d("nice_dup")
    ticks = out["_ticks"] - base["_ticks"]
    coverage = recv / (pub * (n_ready - 1)) if pub and n_ready > 1 else 0.0
    eng = out["_engine"]
    line = {"phase": "nice_path", "n": sim.n, "inbox_impl": sim.ep.inbox_impl,
            "window_s": [base["_t_sim"], out["_t_sim"]],
            "ticks": out["_ticks"], "ticks_measured": ticks,
            "alive": out["_alive"], "warm_wall_s": round(warm_wall, 3),
            "wall_s": round(wall, 3),
            "wall_ms_per_tick": wall * 1e3 / ticks if ticks else 0.0,
            "sim_s_per_wall_s": (out["_t_sim"] - base["_t_sim"]) / wall
            if wall > 0 else 0.0,
            "deliveries_per_wall_s": recv / wall if wall > 0 else 0.0,
            "published": pub, "delivered": recv, "duplicates": dup,
            "coverage": coverage, "coverage_reference": NICE_REFERENCE,
            "coverage_bar": NICE_BAR,
            "duplicate_share": dup / (recv + dup) if recv + dup else 0.0,
            "ready_share": n_ready / max(1, int(s.alive.sum())),
            "layers_mean_window": window_mean(out, base, "nice_layers"),
            "splits": d("nice_splits"), "merges": d("nice_merges"),
            "evictions": d("nice_evicts"), "joins": d("nice_joins"),
            "forwards_dropped": d("nice_fwd_drop"),
            "hops_mean_window": window_mean(out, base, "nice_hops"),
            "pool_factor": sim.ep.pool_factor,
            "outbox_slots": sim.ep.outbox_slots, "engine": eng,
            "launches": launches, "peak_memory_gb": _peak_gb(device),
            "params": dataclasses.asdict(sim.logic.p)}
    healthy = (eng["pool_overflow"] == 0 and eng["outbox_overflow"] == 0
               and line["ready_share"] >= 0.99 and pub > 0
               and coverage >= NICE_REFERENCE["coverage"] - NICE_BAR
               and all(v > 0 for v in launches.values()))
    return sim, s, line, healthy, launches


def due_kinds(sim, s, ticks, kinds):
    """Step ``ticks`` ticks; count the pool's messages of each kind in
    ``kinds`` that were due inside them.  Returns (state, counts)."""
    seen = dict.fromkeys(kinds, 0)
    for _ in range(ticks):
        x = s
        s = sim.run_chunk(s, 1)
        due = x.pool.valid & (x.pool.t_deliver < s.t_now)
        for k, kind in kinds.items():
            seen[k] += int((due & (x.pool.kind == kind)).sum())
    return s, seen


def phase_alm_identity(device, ticks=ALM_TICKS, warm_s=ALM_WARM_S):
    """``alm_identity`` (see the module docstring).  A kind counts where a
    message of it was in the pool before a compared tick and due inside
    it; each overlay needs the kinds its gate names there."""
    from oversim_tpu_torch import tree
    from oversim_tpu_torch.apps import ntree
    from oversim_tpu_torch.common import wire
    from oversim_tpu_torch.overlay import myoverlay as my
    from oversim_tpu_torch.overlay import nice
    from oversim_tpu_torch.overlay import pubsubmmog as ps
    cases = {
        "pubsub": (lambda impl: game_sim(alm_logic("pubsub"), ALM_TARGET,
                                         device, impl),
                   {"sub_call": ps.PS_SUB_CALL, "sub_res": ps.PS_SUB_RES,
                    "unsub": ps.PS_UNSUB, "move": ps.PS_MOVE,
                    "movelist": ps.PS_MOVELIST}, ("sub_call", "sub_res")),
        "my": (lambda impl: game_sim(alm_logic("my"), ALM_TARGET, device,
                                     impl),
               {"ring_join": my.RING_JOIN, "ring_join_ack": my.RING_JOIN_ACK,
                "ring_hello": my.RING_HELLO, "payload": wire.APP_ONEWAY},
               ("ring_join", "ring_hello")),
        "ntree": (lambda impl: ntree_sim(ALM_TARGET, device, impl),
                  {"join": ntree.NT_JOIN, "join_ack": ntree.NT_JOIN_ACK,
                   "event": ntree.NT_EVENT, "event_fwd": ntree.NT_EVENT_FWD},
                  ("join", "join_ack")),
        "nice": (lambda impl: nice_sim(NICE_TARGET, device, impl),
                 {"query": nice.NICE_QUERY, "query_res": nice.NICE_QUERY_RES,
                  "probe": nice.NICE_PROBE, "join": nice.NICE_JOIN,
                  "join_ack": nice.NICE_JOIN_ACK, "hb": nice.NICE_HB,
                  "leader_hb": nice.NICE_LEADER_HB,
                  "split": nice.NICE_SPLIT, "mcast": nice.NICE_MCAST},
                 ("query", "probe", "join", "hb", "leader_hb"))}
    t0 = time.perf_counter()
    line = {"phase": "alm_identity", "ticks": ticks, "warm_s": warm_s}
    for overlay, (build, kinds, need) in cases.items():
        a, b = build("scatter"), build("pallas")
        s0 = b.run_chunk(b.init(SEED), round(warm_s / b.ep.window))
        sa = a.run_chunk(tree.tree_map(lambda x: x.clone(), s0), ticks)
        sb, seen = due_kinds(b, s0, ticks, kinds)
        line[overlay] = {
            "n": b.n, "t_sim": [float(s0.t_now) / 1e9,
                                float(sa.t_now) / 1e9],
            "leaves": compare_states(sa, sb), "due": seen,
            "ready": int(b.logic.ready_mask(sb.logic).sum())}
        if device.type == "cuda":
            sync_free_step(b, sb)
            line[overlay]["host_syncs_in_tick"] = 0
        if min(seen[k] for k in need) <= 0:
            raise AssertionError(f"alm_identity: {overlay} lacks a message "
                                 f"kind of {need} in its ticks: {seen}")
    line["seconds"] = round(time.perf_counter() - t0, 3)
    return line


def alm_record(sim, state):
    """An ``ALM_REF`` run's counters for ``alm_reference``'s line."""
    summ = sim.summary(state)
    names = [k for k in summ if not k.startswith("_")
             and isinstance(summ[k], int)]
    rec = {"n": sim.n, "tick_impl": sim.ep.tick_impl,
           "alive": summ["_alive"], "t_sim": summ["_t_sim"],
           "pool_valid": int(state.pool.valid.sum())}
    rec.update({k: summ[k] for k in names})
    rec["active"] = sum(summ.get(k, 0) for k in (
        "nice_recv", "ps_lists_recv", "ntree_event_delivered",
        "myapp_delivered"))
    return rec


def scribe_coverage(sim, s, seq0):
    """(coverage denominator, READY nodes, rooted groups) of a window
    that started at per-node publish counts ``seq0``: the sum over the
    window's publishes of the READY members of the publisher's group."""
    import torch
    app = s.logic.app
    g = sim.logic.app.p.num_groups
    ready = s.alive & sim.logic.ready_mask(s.logic) & (app.group >= 0)
    grp = torch.clamp(app.group, min=0).long()
    members = torch.bincount(grp[ready], minlength=g)
    pubs = (app.seq - seq0).long()
    den = int(torch.sum(pubs * members[grp] * (app.group >= 0)))
    rooted = int((torch.bincount(grp[ready & app.is_root], minlength=g)
                  > 0).sum())
    return den, int(ready.sum()), rooted


def phase_scribe_path(device):
    """``scribe_path`` (see the module docstring).  Returns (sim, state,
    line, healthy, launches)."""
    import dataclasses
    sim = scribe_sim(SCRIBE_TARGET, device, "pallas")
    seq0 = []
    _reset_peak(device)
    s, base, out, warm_wall, wall, launches = run_window(
        sim, sim.init(SEED), device, DENSE_KERNELS, warm_s=SCRIBE_WARM_S,
        measure_s=SCRIBE_MEASURE_S,
        at_warm=lambda st: seq0.append(st.logic.app.seq.clone()))

    def d(k):
        return out[k] - base[k]

    den, n_ready, rooted = scribe_coverage(sim, s, seq0[0])
    pub, recv = d("alm_published"), d("alm_received")
    ticks = out["_ticks"] - base["_ticks"]
    coverage = recv / den if den else 0.0
    bar = SCRIBE_SHARE * (SCRIBE_REFERENCE["received"]
                          / SCRIBE_REFERENCE["published"])
    eng = out["_engine"]
    groups = sim.logic.app.p.num_groups
    line = {"phase": "scribe_path", "n": sim.n,
            "inbox_impl": sim.ep.inbox_impl,
            "window_s": [base["_t_sim"], out["_t_sim"]],
            "ticks": out["_ticks"], "ticks_measured": ticks,
            "alive": out["_alive"], "warm_wall_s": round(warm_wall, 3),
            "wall_s": round(wall, 3),
            "wall_ms_per_tick": wall * 1e3 / ticks if ticks else 0.0,
            "sim_s_per_wall_s": (out["_t_sim"] - base["_t_sim"]) / wall
            if wall > 0 else 0.0,
            "deliveries_per_wall_s": recv / wall if wall > 0 else 0.0,
            "published": pub, "delivered": recv,
            "coverage_denominator": den, "coverage": coverage,
            "received_per_publish": recv / pub if pub else 0.0,
            "reference": SCRIBE_REFERENCE,
            "received_per_publish_bar": bar,
            "ready_share": n_ready / max(1, int(s.alive.sum())),
            "groups_rooted": [rooted, groups],
            "alm_hops_mean_window": window_mean(out, base, "alm_hops"),
            "alm_latency_s_mean_window": window_mean(out, base,
                                                     "alm_latency_s"),
            "sub_redirects": d("alm_sub_redirects"),
            "joins": d("alm_joins"), "lookup_failed": d("alm_lookup_failed"),
            "inbox_slots": sim.ep.inbox_slots,
            "pool_factor": sim.ep.pool_factor,
            "outbox_slots": sim.ep.outbox_slots, "engine": eng,
            "launches": launches, "peak_memory_gb": _peak_gb(device),
            "params": dataclasses.asdict(sim.logic.app.p)}
    healthy = (eng["pool_overflow"] == 0 and eng["outbox_overflow"] == 0
               and line["ready_share"] >= 0.99 and pub > 0 and recv > 0
               and rooted == groups and recv >= bar * pub
               and all(v > 0 for v in launches.values()))
    return sim, s, line, healthy, launches


def phase_app_identity(device, ticks=APP_TICKS, warm_s=APP_WARM_S):
    """``app_identity`` (see the module docstring): each case warmed on
    the kernels, then ``ticks`` ticks with the kernels and with scatter
    from that state; every leaf equal, the app's message kinds due inside
    the compared ticks."""
    from oversim_tpu_torch import tree
    from oversim_tpu_torch.common import wire
    scribe = {"sub": wire.SCRIBE_SUB, "sub_ack": wire.SCRIBE_SUB_ACK,
              "mcast": wire.SCRIBE_MCAST}
    cases = {
        "simmud": (scribe, ("sub", "sub_ack")),
        "p2pns": ({"reg_call": wire.P2PNS_REG_CALL,
                   "reg_res": wire.P2PNS_REG_RES,
                   "res_call": wire.P2PNS_RES_CALL,
                   "res_res": wire.P2PNS_RES_RES}, ("reg_call", "reg_res")),
        "broadcast": ({"broadcast": wire.BROADCAST}, ("broadcast",)),
        "stack": ({"oneway": wire.APP_ONEWAY, "put": wire.DHT_PUT_CALL,
                   "put_res": wire.DHT_PUT_RES, "get": wire.DHT_GET_CALL},
                  ("oneway", "put"))}
    t0 = time.perf_counter()
    line = {"phase": "app_identity", "ticks": ticks, "warm_s": warm_s}
    for name, (kinds, need) in cases.items():
        a = app_sim(name, APP_TARGET, device, "scatter")
        b = app_sim(name, APP_TARGET, device, "pallas")
        s0 = b.run_chunk(b.init(SEED), round(warm_s / b.ep.window))
        sa = a.run_chunk(tree.tree_map(lambda x: x.clone(), s0), ticks)
        sb, seen = due_kinds(b, s0, ticks, kinds)
        line[name] = {
            "n": b.n, "t_sim": [float(s0.t_now) / 1e9,
                                float(sa.t_now) / 1e9],
            "leaves": compare_states(sa, sb), "due": seen,
            "ready": int(b.logic.ready_mask(sb.logic).sum())}
        if device.type == "cuda":
            sync_free_step(b, sb)
            line[name]["host_syncs_in_tick"] = 0
        if min(seen[k] for k in need) <= 0:
            raise AssertionError(f"app_identity: {name} lacks a message "
                                 f"kind of {need} in its ticks: {seen}")
    line["seconds"] = round(time.perf_counter() - t0, 3)
    return line


def app_record(sim, state):
    """An ``APP_REF`` run's counters for ``app_reference``'s line."""
    rec = alm_record(sim, state)
    rec["active"] = sum(rec.get(k, 0) for k in (
        "alm_received", "p2pns_stored", "bcast_received", "kbr_delivered"))
    return rec


def tier_refs(kind):
    """(runs -> ticks, the tiny simulation, the counters) of the ``alm``
    or ``app`` reference phase."""
    return {"alm": (ALM_REF, tiny_alm_sim, alm_record),
            "app": (APP_REF, tiny_app_sim, app_record)}[kind]


def tier_card_half(kind, device=None):
    """The card half of ``alm_reference`` or ``app_reference`` in a
    process of its own (see ``pastry_card_half``): ({label: (flat state,
    counters)}, {kernel: launches}, card seconds)."""
    from oversim_tpu_torch import interop, kernels
    device = _child_card(device)
    refs, tiny, record = tier_refs(kind)
    t0 = time.perf_counter()
    kernels.reset_launches()
    out = {}
    for label, ticks in refs.items():
        a = tiny(label, device, "pallas")
        sa = a.run_chunk(a.init(SEED), ticks)
        out[label] = (interop.state_to_numpy(sa), record(a, sa))
    _sync(device)
    return out, {k: kernels.LAUNCHES[k] for k in KERNELS}, \
        time.perf_counter() - t0


def phase_tier_reference(device, kind, cpu=None, card=None):
    """``ALM_REF``'s or ``APP_REF``'s runs on the card (kernels;
    ``card``, the child process's ``tier_card_half``, or run here)
    against the CPU (torch ops, held leaf-exact to the JAX package by
    tests/test_torch_nice.py, test_torch_pubsub.py and
    test_torch_ntree.py, or test_torch_scribe.py and
    test_torch_stack.py): integer leaves equal, float leaves within 1e-12
    relative; app traffic in every run; all four kernels launched."""
    name = f"{kind}_reference"
    t0 = time.perf_counter()
    runs, launches, card_s = (card.result() if card is not None
                              else tier_card_half(kind, device))
    t1 = time.perf_counter()
    ref = cpu_result(cpu, name)
    line = {"phase": name, "ticks": tier_refs(kind)[0],
            "float_rtol": CHORD_RTOL, "card_s": round(card_s, 3),
            "card_in_child_process": card is not None,
            "cpu_wait_s": round(time.perf_counter() - t1, 3),
            "launches": launches}
    quiet = []
    for label, (flat, rec) in runs.items():
        rec["leaves"] = compare_states(flat, ref[label],
                                       float_rtol=CHORD_RTOL)
        line[label] = rec
        if rec["active"] <= 0:
            quiet.append(label)
    if quiet:
        raise AssertionError(f"{name} runs without traffic: {quiet}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"{name} never launched {missing}")
    line["seconds"] = round(time.perf_counter() - t0, 3)
    return line, launches


LANES = {"debruijn": ("koorde", "broose"), "epichord": ("epichord", "inet"),
         "gia": ("gia",), "alm": ("nice",), "scribe": ("scribe",)}


def db_lane(phases, overlays=LANES["debruijn"], device=None, barrier=None):
    """The paths of ``overlays`` (``koorde_path`` and ``broose_path``,
    ``epichord_path`` and ``inet_path``, ``gia_path``, or ``nice_path``)
    with their sync checks, identities and profiles (``phases`` names
    which; the EpiChord lane also ``epichord_fast_identity`` and
    ``alm_identity``, GIA's ``vast_identity`` and ``gia_timing``), in a
    process of its own on the card beside the
    parent's phases that measure no time; the profiles come last, after
    the windows (a profiler session slows the ticks after it, PERF.md
    §6), and where ``barrier`` (an Event) is given, only once the parent
    sets it: the parent does so when it has collected every lane before
    this one and waits for it, so the profile and the kernel timing have
    the card to themselves.  Returns (the phases' lines, {overlay:
    {"launches": ..., and GIA's "res" and "bound"}}, the first failed
    gate or None)."""
    import torch
    device = _child_card(device)
    if device.type == "cuda":
        torch.cuda.init()       # the peak-memory counters need it
    t0 = time.perf_counter()

    def stamp(line):
        line["lane_at_s"] = round(time.perf_counter() - t0, 1)
        return line

    lines, got, held = [], {}, []
    for overlay in overlays:
        mine = {f"{overlay}_path", f"{overlay}_identity", f"{overlay}_timing"}
        if not mine & set(phases):
            continue
        warmed = []
        keep = warmed if f"{overlay}_identity" in phases else None
        if overlay == "gia":
            sim, s, line, healthy, launches = phase_gia_path(device,
                                                             keep=keep)
        elif overlay == "nice":
            sim, s, line, healthy, launches = phase_nice_path(device)
        elif overlay == "scribe":
            sim, s, line, healthy, launches = phase_scribe_path(device)
        else:
            sim, s, line, healthy, launches = phase_db_path(device, overlay,
                                                            keep=keep)
        got[overlay] = {"launches": launches}
        s = sync_free_step(sim, s)
        line["host_syncs_per_tick"] = 0
        lines.append(stamp(line))
        if not healthy:
            return lines, got, f"{overlay} path failed its gate"
        if keep is not None:
            lines.append(stamp(
                phase_gia_identity(device, warmed.pop()) if overlay == "gia"
                else phase_db_identity(device, overlay, warmed.pop())))
        held.append((overlay, sim, s, line))
    if "epichord_fast_identity" in phases:
        lines.append(stamp(phase_epichord_fast_identity(device)))
    if "vast_identity" in phases:
        lines.append(stamp(phase_vast_identity(device)))
    if "alm_identity" in phases:
        lines.append(stamp(phase_alm_identity(device)))
    if "app_identity" in phases:
        lines.append(stamp(phase_app_identity(device)))
    if barrier is not None:
        barrier.wait()
    for overlay, sim, s, line in held:
        prof = phase_profile(sim, s, ticks=1, phase=f"{overlay}_profile",
                             cut_from=None)
        for k in ("device_ms_per_tick", "device_idle_share",
                  "launches_per_tick"):
            line[k] = prof[k]
        lines.append(stamp(prof))
        if overlay == "gia" and "gia_timing" in phases:
            timed = []
            got[overlay]["res"], got[overlay]["bound"] = phase_timing(
                sim, s, DENSE_KERNELS, phase="gia_timing", lines=timed)
            lines += [stamp(x) for x in timed]
    return lines, got, None


def _db_lane_main(conn, phases, overlays, barrier):
    """The child process of ``start_db_lane``: sends ``db_lane``'s result
    or the failure's traceback, then leaves without the interpreter's
    exit handlers (a process that ran torch.profiler can hang in
    them)."""
    import traceback
    try:
        conn.send(("ok", db_lane(phases, overlays, barrier=barrier)))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)


def start_db_lane(phases, lane="debruijn"):
    """``db_lane`` of ``LANES[lane]`` in a child process: (process,
    receiving end, lane name, the barrier of GIA's lane or None)."""
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    barrier = ctx.Event() if "gia" in LANES[lane] else None
    proc = ctx.Process(target=_db_lane_main,
                       args=(send, phases, LANES[lane], barrier), daemon=True)
    proc.start()
    send.close()
    return proc, recv, lane, barrier


def stop_db_lane(lane, grace_s=30.0):
    """Join the lane's process, or kill it after ``grace_s``."""
    proc = lane[0]
    proc.join(grace_s)
    if proc.is_alive():
        proc.kill()
        proc.join()


def collect_db_lane(lane, paths):
    """Release the lane's barrier, wait for ``db_lane``, print its lines,
    and fail on its gate."""
    t0 = time.perf_counter()
    if lane[3] is not None:
        lane[3].set()
    try:
        status, res = lane[1].recv()
    except EOFError:
        status, res = "error", "the lane's process ended without a result"
    finally:
        stop_db_lane(lane)
    if status != "ok":
        raise AssertionError(f"db_lane {lane[2]} failed:\n{res}")
    lines, got, failed = res
    wait = round(time.perf_counter() - t0, 1)
    for line in lines:
        main = paths["dense"].get("line")
        if line["phase"] == "inet_path" and main is not None:
            line["main_path_latency_mean_s"] = main["latency_mean_window_s"]
            line["main_path_lookup_hops_mean"] = main["lookup_hops_mean"]
        emit({**line, "in_child_process": True, "lane": lane[2],
              "lane_wait_s": wait})
    for overlay, fields in got.items():
        paths[overlay].update(fields)
    if failed:
        raise AssertionError(failed)


def make_dht_trace(path, seed=1):
    """TRACE_NODES JOINs over 20 s, TRACE_LEAVES LEAVEs in 30-40 s,
    TRACE_OPS PUTs and as many GETs on TRACE_KEYS keys in 21-37 s from the
    nodes that stay (4 or 5 per node, 3 s apart), node types 0 and 1 split
    both ways over TRACE_PART.  Returns the number of PUT/GET lines."""
    import numpy as np
    rs = np.random.default_rng(seed)
    n = TRACE_NODES
    ids = np.arange(1, n + 1)
    t_join = np.sort(rs.uniform(0.0, 20.0, n))
    leave = rs.choice(ids, TRACE_LEAVES, replace=False)
    stay = np.setdiff1d(ids, leave)
    ops = 2 * TRACE_OPS
    who = np.tile(stay, -(-ops // len(stay)))[:ops]
    slot = np.arange(ops) // len(stay)          # 0..4 per node
    t_op = 21.0 + (who % 5) * 0.2 + 3.0 * slot + rs.uniform(0, 1.0, ops)
    keys = rs.integers(0, TRACE_KEYS, ops)
    put = rs.permutation(np.arange(ops) % 2 == 0)
    lines = [(t_join[i], f"{t_join[i]:.6f} {i + 1} JOIN") for i in range(n)]
    lines += [(t, f"{t:.6f} {w} PUT key{k} val{i}" if p
               else f"{t:.6f} {w} GET key{k}")
              for i, (t, w, k, p) in enumerate(zip(t_op, who, keys, put))]
    t_leave = rs.uniform(30.0, 40.0, TRACE_LEAVES)
    lines += [(t, f"{t:.6f} {w} LEAVE") for t, w in zip(t_leave, leave)]
    for a, b in ((0, 1), (1, 0)):
        lines.append((TRACE_PART[0],
                      f"{TRACE_PART[0]} 0 DISCONNECT_NODETYPES {a} {b}"))
        lines.append((TRACE_PART[1],
                      f"{TRACE_PART[1]} 0 CONNECT_NODETYPES {a} {b}"))
    lines.sort(key=lambda x: x[0])
    with open(path, "w") as f:
        f.write("\n".join(x for _, x in lines) + "\n")
    return ops


def phase_trace_path(device):
    """Kademlia + DHT driven by ``make_dht_trace``'s file, parsed through
    the native scanner, built from an ini by ``build_simulation`` with
    the main path's EngineParams on the kernels, run to TRACE_UNTIL_S.
    Gate: no overflow, every trace command issued, ``partition_lost`` >
    0, both dense kernels launched.  Returns the launches."""
    import torch
    from oversim_tpu_torch import kernels, native, trace
    from oversim_tpu_torch.config.ini import IniFile
    from oversim_tpu_torch.config.scenario import build_simulation
    t0 = time.perf_counter()
    os.makedirs(INI_DIR, exist_ok=True)
    path = os.path.join(INI_DIR, "dht.trace")
    n_cmds = make_dht_trace(path)
    t1 = time.perf_counter()
    rows = native.scan_trace(path)
    if rows is None:
        raise AssertionError("the native trace scanner did not build")
    events = trace.parse_trace(path)
    parse_s = time.perf_counter() - t1
    if len(events) != len(rows):
        raise AssertionError("trace parse and native scan disagree")
    t1 = time.perf_counter()
    sim = build_simulation(IniFile.loads("[Config T]\n" + KAD_INI + DHT_INI),
                           "T", engine_params=main_engine_params(),
                           trace_events=events, device=device)
    build_s = time.perf_counter() - t1
    _reset_peak(device)
    s = sim.init(SEED)
    _sync(device)
    kernels.reset_launches()
    t1 = time.perf_counter()
    s = sim.run_until_device(s, TRACE_UNTIL_S, chunk=CHUNK)
    _sync(device)
    wall = time.perf_counter() - t1
    launches = {k: kernels.LAUNCHES[k] for k in DENSE_KERNELS}
    out = sim.summary(s)
    eng = out["_engine"]
    issued = int(s.logic.app.tr_cur.sum())
    queued = int((s.logic.app.tr_kind > 0).sum())
    ops = out["dht_put_success"] + out["dht_get_success"]
    line = {"phase": "trace_path", "nodes": sim.n, "commands": n_cmds,
            "queued": queued, "issued": issued,
            "node_types": sim.up.num_node_types,
            "partition_s": list(TRACE_PART), "t_sim": out["_t_sim"],
            "ticks": out["_ticks"], "alive": out["_alive"],
            "trace_parse_s": round(parse_s, 3), "build_s": round(build_s, 3),
            "native_scanner": True,
            **{k: out[k] for k in ("dht_put_attempts", "dht_put_success",
                                   "dht_get_attempts", "dht_get_success",
                                   "dht_get_notfound", "dht_get_wrong",
                                   "dht_lookup_failed")},
            "put_success_ratio": out["dht_put_success"]
            / max(out["dht_put_attempts"], 1),
            "get_success_ratio": out["dht_get_success"]
            / max(out["dht_get_attempts"], 1),
            "partition_lost": eng["partition_lost"],
            "dht_ops_per_s": ops / wall if wall > 0 else 0.0,
            "wall_s": round(wall, 3),
            "wall_ms_per_tick": wall * 1e3 / out["_ticks"],
            "peak_memory_gb": _peak_gb(device),
            "engine": eng, "launches": launches,
            "seconds": round(time.perf_counter() - t0, 3)}
    emit(line)
    if not (eng["pool_overflow"] == 0 and eng["outbox_overflow"] == 0
            and issued == queued == n_cmds and eng["partition_lost"] > 0
            and all(v > 0 for v in launches.values())):
        raise AssertionError("trace path failed its gate")
    return launches


def kernels_line(errs, paths):
    """The ``kernels`` line: each kernel's numbers from its own path
    (``alloc_dest`` runs on both: its main fields are the dense path's,
    its ``sparse_*`` fields the sparse path's at Q = 2,097,152;
    ``inbox_select_gather``'s ``gather_*`` fields are its gather step
    timed alone).  ``ms`` is the graph-replayed device time."""
    def fields(path, name, prefix=""):
        p = paths[path]
        r = p.get("res", {}).get(name, {})
        out = {"launches": p.get("launches", {}).get(name),
               "ms": r.get("device_ms"),
               "plain_ms": r.get("plain_ms"),
               "bound_ms": p.get("bound", {}).get(name),
               "library_ms": r.get("library_ms"),
               "device_ms": r.get("device_ms"), "call_ms": r.get("call_ms"),
               "ops_per_call": r.get("ops_per_call")}
        if r.get("hot_device_ms") is not None:
            out["hot_device_ms"] = r["hot_device_ms"]
        return {prefix + k: v for k, v in out.items()}

    entries = []
    for name, meta in KERNELS.items():
        e = {"name": name, "route": "cuda", "source": meta["source"],
             "replaces": meta["replaces"], "max_abs_err": errs.get(name),
             "bound_by": "bytes"}
        e.update(fields("dense" if name in DENSE_KERNELS else "sparse", name))
        if name == "alloc_dest":
            e["sparse_q"] = MOUT * 2 * TGT_SPARSE
            e.update(fields("sparse", name, prefix="sparse_"))
        for path in ("chord", "chord_sparse", "dht", "dht_sparse",
                     "campaign", "campaign_sparse", "service", "ingest",
                     "service_reference", "ini_reference", "cli", "pareto",
                     "trace", "pastry_reference", "pastry",
                     "koorde_reference", "broose_reference", "koorde",
                     "broose", "epichord_reference", "inet_reference",
                     "epichord", "inet", "gia", "gia_reference",
                     "vast_reference", "nice", "alm_reference", "scribe",
                     "app_reference"):
            e[f"{path}_launches"] = paths[path].get("launches", {}).get(name)
        if name == "alloc_dest":
            e["ingest_inject_launches"] = paths["ingest"].get(
                "inject_launches")
        if name in DENSE_KERNELS:
            for path in ("dht", "pareto", "gia"):
                e.update({k: v for k, v in fields(path, name,
                                                   prefix=path + "_").items()
                          if k != path + "_launches"})
        if name == "inbox_select_gather":
            for path, prefix in (("dense", "gather_"), ("dht", "dht_gather_"),
                                 ("gia", "gia_gather_")):
                e.update({k: v for k, v in fields(path, "inbox_gather",
                                                   prefix=prefix).items()
                          if not k.endswith("launches")})
        entries.append(e)
    return {"kernels": entries}


PHASES = ("kernel_check", "reference", "identity", "main_path", "timing",
          "profile", "sparse_reference", "sparse_identity", "sparse_path",
          "sparse_timing", "sparse_profile", "chord_reference",
          "chord_path", "chord_identity", "chord_profile",
          "chord_sparse_reference", "dht_reference", "dht_path",
          "dht_sync_check", "dht_timing", "dht_identity", "dht_profile",
          "dht_sparse_reference", "campaign_reference", "campaign_path",
          "campaign_sync_check", "campaign_identity", "campaign_profile",
          "service_path", "ingest_path", "ingest_alloc_check",
          "service_reference", "ini_reference", "ini_identity", "cli_path",
          "pareto_path", "pareto_timing", "trace_path", "pastry_reference",
          "pastry_path", "pastry_identity", "koorde_reference",
          "broose_reference", "koorde_path", "koorde_identity",
          "broose_path", "broose_identity", "epichord_reference",
          "epichord_path", "epichord_identity", "epichord_fast_identity",
          "inet_reference", "inet_path", "inet_identity", "gia_reference",
          "gia_path", "gia_identity", "gia_timing", "vast_reference",
          "vast_identity", "alm_reference", "nice_path", "alm_identity",
          "app_reference", "scribe_path", "app_identity")
# --phases accepts these group names for the phases they list
GROUPS = {
    "dense": ("kernel_check", "reference", "identity", "main_path",
              "timing", "profile"),
    "sparse": ("sparse_reference", "sparse_identity", "sparse_path",
               "sparse_timing", "sparse_profile"),
    "chord": ("chord_reference", "chord_path", "chord_identity",
              "chord_profile", "chord_sparse_reference"),
    "dht": ("dht_reference", "dht_path", "dht_sync_check", "dht_timing",
            "dht_identity", "dht_profile", "dht_sparse_reference"),
    "campaign": ("campaign_reference", "campaign_path",
                 "campaign_sync_check", "campaign_identity",
                 "campaign_profile"),
    "service": ("service_path", "ingest_path", "ingest_alloc_check",
                "service_reference"),
    "ini": ("ini_reference", "ini_identity", "cli_path", "pareto_path",
            "pareto_timing", "trace_path"),
    "pastry": ("pastry_reference", "pastry_path", "pastry_identity"),
    "debruijn": ("koorde_reference", "broose_reference", "koorde_path",
                 "koorde_identity", "broose_path", "broose_identity"),
    "epichord": ("epichord_reference", "epichord_path", "epichord_identity",
                 "epichord_fast_identity"),
    "inet": ("inet_reference", "inet_path", "inet_identity"),
    "gia": ("gia_reference", "gia_path", "gia_identity", "gia_timing"),
    "vast": ("vast_reference", "vast_identity"),
    "alm": ("alm_reference", "nice_path", "alm_identity"),
    "scribe": ("app_reference", "scribe_path", "app_identity"),
}
DHT_PATH_PHASES = {"dht_path", "dht_sync_check", "dht_timing",
                   "dht_identity", "dht_profile"}
CAMPAIGN_PATH_PHASES = {"campaign_path", "campaign_sync_check",
                        "campaign_identity", "campaign_profile"}
LANE_PHASES = {lane: {f"{o}_{p}" for o in overlays
                      for p in ("path", "identity")}
               for lane, overlays in LANES.items()}
LANE_PHASES["epichord"].add("epichord_fast_identity")
LANE_PHASES["gia"] |= {"gia_timing", "vast_identity"}
# alm_identity runs in EpiChord's lane, the first to finish (in the
# fourth lane, after NICE's path, the parent waited for it)
LANE_PHASES["epichord"].add("alm_identity")
LANE_PHASES["scribe"].add("app_identity")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: CUDA is not available; the port's "
                         "main path runs on the card only\n")
        return 2
    sys.path.insert(0, HERE)
    from oversim_tpu_torch import kernels
    want = set(PHASES)
    if "--phases" in sys.argv:
        want = set()
        for name in sys.argv[sys.argv.index("--phases") + 1].split(","):
            want |= set(GROUPS.get(name, (name,)))
        if want - set(PHASES):
            raise SystemExit(f"unknown phases {sorted(want - set(PHASES))}")
    t_all = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "kind": kind, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = kernels.build_all(verbose=True)
    for name in kernels.SOURCES:
        kernels.library(name)
    ptxas = {k: ptxas_summary(v) for k, v in logs.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": ptxas})
    local = [f"{src}:{fn}" for src, fns in ptxas.items()
             for fn, (_, frame, spill) in fns.items() if frame or spill]
    if local:
        raise AssertionError(f"kernels with a stack frame or spills: {local}")

    # the reference phases' CPU halves run in one helper process,
    # queued now, while the card runs the phases before each
    pool = concurrent.futures.ProcessPoolExecutor(
        HELPERS, mp_context=multiprocessing.get_context("spawn"))
    # five more processes for eleven reference phases' card halves (see
    # below)
    card_pool = concurrent.futures.ProcessPoolExecutor(
        5, mp_context=multiprocessing.get_context("spawn"))
    lanes = []      # the lanes' processes (``start_db_lane``)
    try:
        jobs = {name: pool.submit(cpu_half, name) for name in REF_TICKS
                if name in want}
        errs = {}
        # per path: {"launches": {...}, "res": {...}, "bound": {...}}
        paths = {"dense": {}, "sparse": {}, "chord": {}, "chord_sparse": {},
                 "dht": {}, "dht_sparse": {}, "campaign": {},
                 "campaign_sparse": {}, "service": {}, "ingest": {},
                 "service_reference": {}, "ini_reference": {}, "cli": {},
                 "pareto": {}, "trace": {}, "pastry_reference": {},
                 "pastry": {}, "koorde_reference": {},
                 "broose_reference": {}, "koorde": {}, "broose": {},
                 "epichord_reference": {}, "inet_reference": {},
                 "epichord": {}, "inet": {}, "gia": {}, "gia_reference": {},
                 "vast_reference": {}, "nice": {}, "alm_reference": {},
                 "scribe": {}, "app_reference": {}}
        if "kernel_check" in want:
            t0 = time.perf_counter()
            n_sp = 2 * TGT_SPARSE
            cap_sp = max(64, n_sp // 8)
            # both inbox entries run every inbox case, at both paths' shapes
            e_dense, c_dense = check_inbox(N_MAIN, device)
            e_sparse, c_sparse = check_inbox(n_sp, device, seed=29)
            e_edge, c_edge = check_inbox_edges(n_sp, device)
            e_gia, c_gia = check_inbox(GIA_TARGET, device, seed=53)
            e_g, n_g = check_gather(device)
            errs["inbox_select"] = max(e_dense, e_sparse, e_edge, e_gia)
            errs["inbox_select_gather"] = max(errs["inbox_select"], e_g)
            e_al, n_al = check_alloc(N_MAIN, device)
            e_alg, n_alg = check_alloc(GIA_TARGET, device)
            e_ae, n_ae = check_alloc_edges(device)
            errs["alloc_dest"] = max(e_al, e_alg, e_ae)
            errs["compact_indices"], n_cp = check_compact(n_sp, cap_sp, device)
            emit({"phase": "kernel_check",
                  "dense": {"n": N_MAIN, "r": R, "p": POOL_FACTOR * N_MAIN,
                            "q": MOUT * N_MAIN},
                  "sparse": {"n": n_sp, "r": R, "p": POOL_FACTOR * n_sp,
                             "m": n_sp, "cap": cap_sp},
                  "gia": {"n": GIA_TARGET, "r": R,
                          "p": POOL_FACTOR * GIA_TARGET,
                          "q": MOUT * GIA_TARGET},
                  "repeats_per_case": REPEATS,
                  "inbox": {"cases_dense": c_dense, "cases_sparse": c_sparse,
                            "cases_gia": c_gia, "edge_cases": c_edge,
                            "max_abs_err": errs["inbox_select"]},
                  "alloc_dest": {"cases": n_al, "cases_gia": n_alg,
                                 "edge_cases": n_ae,
                                 "max_abs_err": errs["alloc_dest"]},
                  "inbox_gather": {"cases": n_g, "max_abs_err": e_g},
                  "compact_indices": {"cases": n_cp,
                                      "max_abs_err": errs["compact_indices"]},
                  "tolerance": "exact",
                  "seconds": round(time.perf_counter() - t0, 3)})

        if "reference" in want:
            emit(phase_reference(device, cpu=jobs.get("reference")))
        if "identity" in want:
            emit(phase_identity(device, N_MAIN))
        warmed = []     # the main path's state at WARM_S (service_path)
        if want & {"main_path", "timing", "profile", "service_path"}:
            sim, s, got, paths["dense"]["line"] = phase_main_path(
                device, N_MAIN, keep=warmed if "service_path" in want
                else None)
            main_sim = sim
            paths["dense"]["launches"] = got
            if "timing" in want:
                dp = paths["dense"]
                dp["res"], dp["bound"] = phase_timing(sim, s, DENSE_KERNELS)
            if "profile" in want:
                emit(phase_profile(sim, s))
            del sim, s
        if "sparse_reference" in want:
            emit(phase_sparse_reference(
                device, cpu=jobs.get("sparse_reference")))
        if "sparse_identity" in want:
            emit(phase_sparse_identity(device))
        if want & {"sparse_path", "sparse_timing", "sparse_profile"}:
            sim, s, got = phase_sparse_path(device)
            paths["sparse"]["launches"] = got
            if "sparse_timing" in want:
                sp = paths["sparse"]
                sp["res"], sp["bound"] = phase_timing(
                    sim, s, SPARSE_KERNELS, phase="sparse_timing")
            if "sparse_profile" in want:
                emit(phase_profile(sim, s, phase="sparse_profile"))
            del sim, s
        if "chord_reference" in want:
            emit(phase_chord_reference(
                device, cpu=jobs.get("chord_reference")))
        if want & {"chord_path", "chord_identity", "chord_profile"}:
            sim, s, got = phase_chord_path(device, N_MAIN)
            paths["chord"]["launches"] = got
            if "chord_identity" in want:
                emit(phase_chord_identity(device, N_MAIN, s))
            if "chord_profile" in want:
                emit(phase_profile(sim, s, phase="chord_profile"))
            del sim, s
        if "chord_sparse_reference" in want:
            line, paths["chord_sparse"]["launches"] = \
                phase_chord_sparse_reference(
                    device, cpu=jobs.get("chord_sparse_reference"))
            emit(line)
        if want & DHT_PATH_PHASES:
            sim, s, line, healthy, paths["dht"]["launches"] = phase_dht_path(
                device)
            if "dht_profile" in want:
                prof = phase_profile(sim, s, phase="dht_profile")
                for k in ("device_ms_per_tick", "device_idle_share",
                          "launches_per_tick"):
                    line[k] = prof[k]
            emit(line)
            if not healthy:
                raise AssertionError("dht path failed its gate")
            if "dht_profile" in want:
                emit(prof)
            if "dht_timing" in want:
                paths["dht"]["res"], paths["dht"]["bound"] = phase_timing(
                    sim, s, DENSE_KERNELS, phase="dht_timing")
            s = sync_free_step(sim, s)
            emit({"phase": "dht_sync_check", "host_syncs_in_tick": 0})
            if "dht_identity" in want:
                emit(phase_dht_identity(device, DHT_TARGET, s))
            del sim, s
        if "dht_sparse_reference" in want:
            line, paths["dht_sparse"]["launches"] = \
                phase_dht_sparse_reference(
                    device, cpu=jobs.get("dht_sparse_reference"))
            emit(line)
        if want & CAMPAIGN_PATH_PHASES:
            camp, cs, line, paths["campaign"]["launches"] = \
                phase_campaign_path(device)
            if "campaign_profile" in want:
                prof = phase_profile(camp, cs, ticks=1,
                                     phase="campaign_profile")
                prof["s"] = camp.s
                prof["launches_per_tick_per_replica"] = \
                    prof["launches_per_tick"] / camp.s
                emit(prof)
            cs = campaign_sync_check(camp, cs)
            emit({"phase": "campaign_sync_check", "host_syncs_in_tick": 0,
                  "s": camp.s})
            if "campaign_identity" in want:
                emit(phase_campaign_identity(camp, cs))
            del camp, cs
        # the de Bruijn paths, EpiChord's and inet's (with
        # alm_identity), GIA's (with vast_identity) and NICE's run in
        # four processes of their own from here, beside the phases up to
        # cli_path, which measure no time; GIA's lane times its profile
        # and kernels once the two before it are in
        for name, phases in LANE_PHASES.items():
            if want & phases:
                lanes.append(start_db_lane(sorted(want & phases), name))
        if "service_path" in want:
            paths["service"]["launches"] = phase_service_path(
                device, main_sim, warmed.pop())
        if want & {"ingest_path", "ingest_alloc_check"}:
            line, got, burst = phase_ingest_path(device)
            paths["ingest"].update(launches=got, inject_launches=line[
                "inject_alloc_dest_launches"])
            if "ingest_alloc_check" in want:
                line = phase_ingest_alloc_check(burst, device)
                errs["alloc_dest"] = max(errs.get("alloc_dest", 0),
                                         line["max_abs_err"])
                emit(line)
            del burst
        # the CLI's child process and the card halves of
        # ini_reference, pastry_reference, campaign_reference,
        # dht_reference, the four lane overlays' references, GIA's,
        # Vast's and the ALM overlays' run in
        # child processes beside service_reference, whose card work is
        # compared and not timed; those phases compare their results
        # after it
        child = cli_child_start() if "cli_path" in want else None
        cards = {name: card_pool.submit(*job) for name, job in (
            ("broose_reference", (db_card_half, "broose")),
            ("ini_reference", (ini_card_half,)),
            ("pastry_reference", (pastry_card_half,)),
            ("campaign_reference", (campaign_card_half,)),
            ("dht_reference", (dht_card_half,)),
            ("koorde_reference", (db_card_half, "koorde")),
            ("epichord_reference", (db_card_half, "epichord")),
            ("inet_reference", (db_card_half, "inet")),
            ("gia_reference", (game_card_half, "gia")),
            ("vast_reference", (game_card_half, "vast")),
            ("alm_reference", (tier_card_half, "alm")),
            ("app_reference", (tier_card_half, "app"))) if name in want}
        try:
            if "service_reference" in want:
                line = phase_service_reference(
                    device, cpu=jobs.get("service_reference"))
                paths["service_reference"]["launches"] = line["launches"]
                emit(line)
            if "ini_reference" in want:
                line, paths["ini_reference"]["launches"] = \
                    phase_ini_reference(device, cpu=jobs.get("ini_reference"),
                                        card=cards["ini_reference"])
                emit(line)
        finally:
            if child is not None:
                cli_child_finish(child)
        if "dht_reference" in want:
            emit(phase_dht_reference(device, cpu=jobs.get("dht_reference"),
                                     card=cards["dht_reference"]))
        if "campaign_reference" in want:
            line, paths["campaign_sparse"]["launches"] = \
                phase_campaign_reference(
                    device, cpu=jobs.get("campaign_reference"),
                    card=cards["campaign_reference"])
            emit(line)
        if "ini_identity" in want:
            emit(phase_ini_identity(device))
        if "cli_path" in want:
            paths["cli"]["launches"] = phase_cli_path(device)
        while lanes:
            collect_db_lane(lanes.pop(0), paths)
        if want & {"pareto_path", "pareto_timing"}:
            sim, s, line, healthy, paths["pareto"]["launches"] = \
                phase_pareto_path(device)
            prof = phase_profile(sim, s, ticks=2, phase="pareto_profile",
                                 cut_from=None)
            for k in ("device_ms_per_tick", "device_idle_share",
                      "launches_per_tick"):
                line[k] = prof[k]
            emit(line)
            emit(prof)
            if not healthy:
                raise AssertionError("pareto path failed its gate")
            if "pareto_timing" in want:
                pp = paths["pareto"]
                pp["res"], pp["bound"] = phase_timing(
                    sim, s, DENSE_KERNELS, phase="pareto_timing")
            del sim, s
        if "trace_path" in want:
            paths["trace"]["launches"] = phase_trace_path(device)
        if "pastry_reference" in want:
            line, paths["pastry_reference"]["launches"] = \
                phase_pastry_reference(device,
                                       cpu=jobs.get("pastry_reference"),
                                       card=cards["pastry_reference"])
            emit(line)
        if want & {"pastry_path", "pastry_identity"}:
            warmed = []
            sim, s, line, healthy, paths["pastry"]["launches"] = \
                phase_pastry_path(device, keep=warmed
                                  if "pastry_identity" in want else None)
            prof = phase_profile(sim, s, ticks=1, phase="pastry_profile",
                                 cut_from=None)
            for k in ("device_ms_per_tick", "device_idle_share",
                      "launches_per_tick"):
                line[k] = prof[k]
            s = sync_free_step(sim, s)
            line["host_syncs_per_tick"] = 0
            emit(line)
            emit(prof)
            if not healthy:
                raise AssertionError("pastry path failed its gate")
            del sim, s
            if "pastry_identity" in want:
                emit(phase_pastry_identity(device, warmed.pop()))
        for overlay in DB_REF:
            name = f"{overlay}_reference"
            if name in want:
                line, paths[name]["launches"] = phase_db_reference(
                    device, overlay, cpu=jobs.get(name), card=cards[name])
                emit(line)
        for game in GAME_REF:
            name = f"{game}_reference"
            if name in want:
                line, paths[name]["launches"] = phase_game_reference(
                    device, game, cpu=jobs.get(name), card=cards[name])
                emit(line)
        for tier in ("alm", "app"):
            name = f"{tier}_reference"
            if name in want:
                line, paths[name]["launches"] = phase_tier_reference(
                    device, tier, cpu=jobs.get(name), card=cards[name])
                emit(line)
    finally:
        pool.shutdown(cancel_futures=True)
        card_pool.shutdown(cancel_futures=True)
        for lane in lanes:
            stop_db_lane(lane, grace_s=0.0)
    # the main path's ms per tick tells the host class beside the total
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_all, 3),
          "main_path_wall_ms_per_tick": paths["dense"].get("line", {}).get(
              "wall_ms_per_tick")})
    emit(kernels_line(errs, paths))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
