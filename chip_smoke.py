"""Drive the PyTorch/CUDA port on one card and hold it to its plain versions.

    python3 chip_smoke.py

Phases, each raising on failure (any failure exits non-zero):

1. build every kernel of the port (each ``gpumounter_tpu_torch/ops/csrc/*.cu``)
   with nvcc (sm_90a), all at once, and print the card's name and power
   limit, and the registers and spills that ptxas reports for each
   instance of ``flash_fwd.cu``, ``flash_bwd.cu`` and ``flash_decode.cu``
   (failing on a warning that their wgmma structure broke, or on a spill in
   a wgmma instance);
2. hold each kernel against its plain PyTorch version on the card, case by
   case, with the tolerance stated beside each (``flash_fwd``, then
   ``flash_decode`` and the two backward kernels of ``flash_bwd``, whose
   reruns must also be bit-equal);
3. run the main paths at full width (the config of the repo's train-step
   bench: vocab 2048, d_model 1024, 8 heads of 128, 2 layers, d_ff 4096,
   rope, bf16, max_len 2048), each with the launch counts set to 0 just
   before and read just after:
   - the forward on 3 batches of 4 x 2048 random tokens, its logits held
     against the same forward with the plain attention;
   - serving: greedy ``generate`` from 4 random prompts of 1536 tokens, 512
     new tokens (up to max_len), the prefill and the first decode step run
     as the eager warm-ups of their captures and the other 510 steps
     replays of the step's graph, both graphs cached for later calls, the
     launch counts following the replays (``ops.graphs``); teacher-forced
     ``prefill`` + ``decode_step`` logits held against ``forward`` at every
     generated position; the
     captured loop's tokens held bit for bit against ``generate_loop`` with
     capture=False, greedy and seeded (a CUDA generator, 512 tokens), seeded
     sampling reproducible per seed and different across seeds, and
     ``torch.cuda.memory_allocated()`` unchanged over repeated calls;
   - training: 3 SGD steps of ``make_train_step`` on 4 x 2048 random
     tokens (the first the eager warm-up of the step's capture, the others
     replays of its cached graph), the grads of one batch held leaf by
     leaf against the grads through the plain attention; then
     ``entry.train_check()``;
4. capture one greedy ``decode_step`` as a CUDA graph and replay it at two
   cache lengths, each against an eager step and the forward (a raw
   replay goes through no wrapper; a counted replay adds n_layers
   ``flash_decode`` launches);
   then the MoE probe (the same config with 8 experts): ``moe_ffn`` against
   ``moe_ffn_plain`` at (8192, 1024) in bf16 and f32, and its forward,
   serving (the captured loop and its checks, and the captured step) and
   training paths as above, each
   held block by block against the plain attention (or, serving, against
   the forward's blocks) because a top-1 routing near tie may flip between
   two runs, then ``entry.moe_check()``;
5. time each kernel, its plain version and the PyTorch library call that
   computes the same function (kernels and library calls as device time by
   replaying a CUDA graph of 20 calls, and ``flash_fwd`` and SDPA also
   eagerly per call), the forward, the prefill, the whole greedy
   ``generate``, its capture and its replayed loop (ms per step, decode
   tokens/s, and the share of it the replayed step's device time fills),
   the eager loop beside it, and the train step split into forward,
   backward and update, with CUDA events;
   the backward kernels also with GQA H_kv 2 and window 255, ``flash_decode``
   also at a GQA shape (H 32, H_kv 4) with its achieved TB/s and the device
   time of its split kernel and of its merge from ``torch.profiler``; and
   print the slowest device kernels of one SGD step from ``torch.profiler``;
   the MoE forward, SGD step (split, profiled), prefill and decode loops;
6. the tenant's hot-mount side (``torchside``), each part in child
   processes that run this script with ``--handoff-child``:
   a. CUDA's enumeration is fixed at init: a process started with
      ``CUDA_VISIBLE_DEVICES=""`` reads 0 devices, still reads 0 through
      CUDA after ``set_visibility_env`` (``torch.cuda.init()`` and
      ``refresh_devices()`` raise), then ``handoff``s to a new image that
      sees the card, whose ``wait_for_gpus(1)`` counts 1, and which trains
      one AdamW step on it (the 0 -> 1 hot-add);
   b, c. the full-width dense and MoE trainers: 3 AdamW steps, ``pack``
      (params and optimizer state), ``handoff``; the new image loads,
      restores, takes 3 more steps and a greedy ``generate``; losses, final
      params and tokens held bit for bit against the same run in this
      process without a handoff, one handoff each (three until the script
      neared its time limit), the launch counts of every image checked,
      and the time of each part of the handoff printed (pack, save, exec to CUDA ready, load, restore, the
      optimizer's state, the first step, the tenant's whole side) with
      the checkpoint directory's filesystem (a ``tempfile.mkdtemp()``,
      removed after);
7. dp x tp and expert parallelism (``parallel/``): 4 ranks started once
   for this phase and the next (``parallel.launch.run_ranks``; each rank
   runs phase 7's work, then phase 8's) on a 2 x 2 ("data", "model") mesh, all
   sharing the one card over gloo (NCCL refuses two ranks on one device;
   gloo's all-reduce takes CUDA tensors by way of the host). In them:
   ``entry.tp_checks`` (the dryrun's sharded sections at ``train_check``'s
   dialect: the kernel-vs-plain grads on the mesh within 5e-3, the MoE
   flagship, ``make_moe_step`` over ("data", "expert")); then the full-width
   dense and MoE sharded SGD steps (``entry.sharded_step_check``: local
   shapes, ``flash_fwd``, dq and dk/dv n_layers times a step on every rank
   at H/tp heads, the collectives of ``step_collectives``, replicas
   bit-equal), their gathered new params and loss held against the
   one-process ``make_train_step`` on the same card, weights and tokens, the
   dense grads through the kernels against the plain attention's on the
   mesh, and each rank's step time, gloo all-reduce time and gradient
   sums' time;
8. sequence and pipeline parallelism (``parallel/ring_attention.py``,
   ``pipeline.py``, ``pipeline_train.py``): phase 7's 4 ranks on the
   card over gloo (its point-to-point calls take no CUDA tensor, so the
   ring's shifts go by way of host buffers), with (data, seq) meshes of
   2 x 2 and 1 x 4 and a ("pipe",) mesh of 4. In them: ring attention on
   1 x 4 at the full-width chunk shapes (B4 H8 L2048 as 4 chunks of 512,
   D128, bf16: every rank meets a skipped, the diagonal and a past chunk)
   against ``flash_attention`` over the whole sequence, forward and dq,
   dk, dv; the full-width dense and MoE SGD steps with attn_parallel "seq"
   on both meshes (``step_collectives``, each training kernel (c + 1) x
   n_layers times a step at seq coordinate c, replicas bit-equal, the
   loss and params against the one-process step on the same card); GPipe
   (P 4, n_layers 4) and the interleaved schedule (P 4, v 2, n_layers 8)
   at full width, n_micro 4 on B4 L2048, against the one-process step;
   and times: each step a rank, one shift, the ring a layer against one
   ``flash_attention`` over the whole sequence, and the pipelines'
   ``schedule_info`` bubble fraction against each rank's time in the
   shifts;
9. the mesh-growing hot-add and the multichip dryrun, ranks sharing the
   card over gloo:
   a. ``entry.grow_checks`` at full width, dense then MoE in the same
      two worlds: 2 ranks on a
      (1, 2) ("data", "model") mesh take 2 AdamW steps, pack params and
      optimizer state through the placement (every leaf gathered whole),
      rank 0 saves; 4 new ranks on (2, 2) load, restore their shards (held
      bit-equal to ``shard_params`` of the packed state, and gathered again
      bit-equal), load the optimizer's state and take 2 more steps, the
      first held against one process from the same state; the launches of
      every rank's steps, and the host-clock parts of the hot-add (pack
      with its gather, save, the new world's start, load, restore, the
      optimizer's state, the first step);
   b. ``entry.dryrun_multichip(8)``, the reference's own shape: its
      sections on 8 ranks (``tp_checks`` on (1, 8): 2 q heads and 1 kv head
      a rank; ``seq_checks`` on (2, 4); ``pipeline_checks`` on 4 stages),
      then the stretch, 16 ranks on the H100 plan's (2, 8) mesh; each
      section's numbers against its limits and its launches per rank;
10. the control plane's hot-mount of a GPU on one node, in process:
    0. the native layer built first (g++ from
       ``gpumounter_tpu_torch/native/``: the namespace helper and the /proc
       scan's library; its build time printed beside the kernels'), then
       the namespace entry timed, 3 runs with the compiled helper and 3
       with its plain version (``nsutil/nsexec.py`` in a new interpreter);
       phases 10-22 enter namespaces through the compiled helper;
    a. the live ``NvidiaDeviceBackend`` on /dev (identity from the
       driver's procfs where it lists the GPUs, else NVML): exactly one
       GPU, its UUID and PCI bus id equal to nvidia-smi's, its node's and
       every companion's major:minor equal to os.stat's; each nvidia*
       node printed with what it was tied to (a node of no GPU's minor is
       no device);
    b. this process (CUDA open) among the GPU's holders in the native
       /proc scan, which finds the holders the plain scan finds over the
       same processes, ``probe_device`` healthy; one scan of each timed;
    c. ``entry.mount_check``: ``GpuMountService`` over a ``FakeCluster``
       of the live backend; add_gpu(1) into a tmpfs directory through this
       process's mount namespace, granting on a child of the cgroup-v1
       devices hierarchy where one is writable: with CAP_MKNOD (read from
       CapEff first) the node and its companions land as character devices
       with the card's numbers (``gpus_visible_in_dev`` reads 1) and
       remove_gpu takes them away and releases the slave pod; without it
       add_gpu fails with the refusal naming CAP_MKNOD and is rolled back;
       3 times each, timed; the same flows on a fake host of 8 GPUs
       (add_gpu(1) and add_gpu(8));
11. the hot-mount through the master: ``entry.master_check``, the port's
    ``MasterApp`` on an HTTP server on 127.0.0.1 routing to that
    ``GpuMountService`` over the worker's gRPC server (the kubelet's
    pod-resources over its gRPC socket too):
    a. GET /addgpu/namespace/default/pod/<pod>/gpu/1/isEntireMount/false,
       the node checked in the tenant directory, then POST
       /removegpu/.../force/false with its UUID, the node gone and the
       slave pod released; 3 times, each request's round trip printed
       beside phase 10's in-process add_gpu(1) and remove_gpu (the
       difference is the master, HTTP and the codec);
    b. a tenant child (``--mount-child``) with CUDA_VISIBLE_DEVICES set to
       the UUID the HTTP add mounted: CUDA's device 0 has that UUID, and
       phase 3's first forward runs through ``flash_fwd`` (2 launches, NLL
       in phase 3's range); its exec -> CUDA ready printed beside phase 6's;
    c. the error mapping on the live host: gpu/2 on the one card answers 500
       Insufficient (a second nvidiaN node of the card is no GPU), an
       unknown pod 404, an unknown UUID 400, no token 401; the flows of 1
       and 8 GPUs and the same errors on a fake host of 8 GPUs; the worker
       call alone and the codec timed;
    d. the slice and batch routes, ``entry.slice_check``: the master in
       front of one worker gRPC server a node. On the card, a slice of 1
       host x 1 GPU: POST /addslice (acceleratorType nvidia-h100-80gb) into
       a target pod at 127.0.0.1, the plan's env printed; a tenant child
       (``--slice-child``) on the UUID it mounted, whose environment holds
       the plan's worker env and no other distributed variable, calls
       ``torchside.visibility.reinit_distributed(MASTER_ADDR:<port>,
       WORLD_SIZE, NODE_RANK x NPROC_PER_NODE)``, all-reduces a CUDA tensor
       (NCCL, world size 1) and runs phase 3's first forward through
       ``flash_fwd``; POST /removeslice, the node gone and the slave pod
       released. On a fake fleet of 4 hosts x 8 GPUs: the slice of all 32
       added and removed; a slice of 4 x 1 with one host squatted, rolled
       back (503); a batch of 8 targets on the 4 nodes and a pod that does
       not exist (8 Success, 1 PodNotFound). 3 times each, every request's
       round trip printed beside phase 11's /addgpu and /removegpu, with
       the fan-out core's tasks by kind;
12. the cgroup v2 device controller on the card's GPU,
    ``entry.cgroup_v2_check`` (the card's machine runs cgroup v1, so the
    phase shows what it can and prints which branch it took):
    a. always: the live GPU and its companions as stat(2) gives them
       (phase 10's inventory); the v2 program for them assembled, with the
       defaults and with the telemetry and policy maps, timed; a grant and
       the last revoke through ``V2DeviceController`` on the stubbed kernel
       (``testing/bpf.py``), the legacy path and the map path, every
       verdict from ``interpret_device_program``: rw on the GPU's node and
       each companion admitted after the grant, a neighbouring minor
       denied, and after the revoke runc's program back alone and all of
       them denied; grant and revoke timed;
    b. the kernel probed: a BPF map's creation and a device program's
       load, a cgroup2 and a bpffs mount; each errno's name printed;
    c. where all four succeed, the round trip on the kernel, in a child
       cgroup2: runc's default program attached, a tenant child
       (``--v2-child``) in that cgroup refused /dev/nvidiaN (EPERM),
       ``grant_many``, the same child opening the node and the companions
       and running phase 3's first forward through ``flash_fwd``, a
       restarted controller restoring the grant from the pins and revoking
       it, ``prog_query``'s ids as before the grant, the child refused
       again; a failure of any step fails the run. Where one fails, the
       phase goes on;
13. tracing, audit and failpoints on a live hot-mount, ``entry.obs_check``
    through the master over gRPC as in phase 11 (no kernel runs):
    a. 3 traced round trips of the live GPU: a trace id on each response;
       /trace/<id> holds http.add -> rpc.AddGPU -> worker.AddGPU ->
       mount.slave_pod_schedule, mount.cgroup_grant, mount.mknod,
       mount.verify (and k8s.get_pod under http.add), each ok and parented
       as listed, and the remove's spans likewise; no span left open; the
       edge's and the worker's audit records under each id; /timeline; the
       Events GPUMounted and GPUUnmounted; each span's ms, the worker's
       spans' share of worker.AddGPU, and the traced add and remove beside
       phase 11's;
    b. faults, each ending with the GPU addable again:
       worker.mount.after_grant (500, rolled back, nothing left, the error
       audited under the same trace id), rpc.client.call (200 after one
       retry under one idempotency key, the worker called once),
       master.slice.mount on a live slice of 1 (500, nothing changed); on a
       fake 8-GPU host an add of 2 under worker.mount.mknod=1*pass->1*error
       (500, neither GPU mounted);
    c. the costs on the card's host: fire() with nothing armed, one empty
       span, one audited record, and from these an estimate of the spans'
       and records' share of one add;
14. the worker's durability on a live hot-mount, ``entry.durability_check``
    through the master over gRPC as in phase 11, each worker's ledger in a
    directory beside this script (the machine's disk, not the tmpfs):
    a. what the ledger costs: 3 HTTP adds and removes of the live GPU with
       the ledger and 3 without, in turns, each median with its runs, the
       ledger's appends an add and a remove (2 each), one append's fsync,
       and from these the ledger's share of an add;
    b. worker.mount.after_grant=1*crash on a live add (500, one txn open);
       a new ``GpuMountService`` over the same ledger and
       ``LedgerResync.replay_once()`` (timed): one open txn,
       replayed-completed, the GPU's node in the target's /dev, books ==
       mounts == ledger; a tenant child (``--mount-child``) on that GPU runs
       phase 3's first forward through ``flash_fwd`` (its launches counted
       in the kernels line);
    c. on the fake 8-GPU host, worker.mount.before_grant=1*crash on an add
       of 2, the slave pods deleted before the restart: replayed-rolled-back,
       no node, no booking, no open txn;
    d. drain() from another thread while a live add is inside the namespace
       helper (its mount.mknod span): the add finishes, a second add gets
       UNAVAILABLE "worker draining", a reopened ledger reads a clean
       shutdown with no open txn;
    e. over real gRPC, an add with epoch 5 mounts, a remove with epoch 3
       raises ``FencedError`` (tpumounter_fenced_writes_total + 1, nothing
       changed), a master whose client stamps epoch 3 answers 503 with
       Retry-After 1, and after a restart the ledger reads epoch 5 back;
    f. on the fake host, a remove while the API refuses deletes: 200, the
       release deferred into the ledger (the series + 1, one entry), the
       queue emptied by ``retry_pending_releases()`` once healed; an owner
       pod deleted: one ``SlaveReaper.reap_once()`` deletes its slave pod
       and frees the GPU.
    Cases a, b, d and e run on the card's own GPU: without CAP_MKNOD the
    phase fails.
15. the master's store through an API outage on a live hot-mount,
    ``entry.degraded_check`` through the master over gRPC as in phase 11,
    with the default ``CachedMasterStore``, the worker's ledger and the
    write-behind queue in a directory beside this script; the "API server"
    is the cluster's in-process ``FakeKubeClient`` (this machine has none),
    partitioned by ``set_partitioned`` and shared by the master and the
    worker, with short ApiHealth thresholds (printed):
    a. 3 live HTTP adds and removes through the store-backed registry, each
       median beside phase 11's; /healthz "ok", /apihealth healthy with the
       registry's cache age and an empty queue;
    b. a write partition around a live remove: the write plane driven down
       (timed); /healthz 200 "api: down"; 3 stamps and a CAS stamp (seq 1)
       deferred (4 on disk, the series + 4); the remove 200, the GPU's node
       gone, its slave release deferred into the ledger, the next release's
       probe trying one record of 3; an add refused 500 (the reference's
       code) with nothing mounted and no new slave pod; healed (a newer
       writer's seq 5 first; timed), the flush applies the 3 once each and
       drops the CAS one as lost-cas (timed), a queue reopened from disk holds
       nothing, the releases retried, books == mounts == ledger;
    c. a read partition around a live add: the registry answers from its
       cache, the store's worker LIST is served stale (its age on
       /apihealth), the add fails 500 at the pod read with no worker call, a
       stamp lands directly; healed, the add mounts the GPU and a tenant
       child (``--mount-child``) on it runs phase 3's first forward through
       ``flash_fwd`` (its launches counted in the kernels line);
    d. the costs on the card's host, medians of 20: one tracked call over
       the raw fake, one read through the cache, one enqueue with its fsync.
    Cases a, b and c run on the card's own GPU: without CAP_MKNOD the phase
    fails.
16. sharded masters and the warm pool on a live hot-mount,
    ``entry.shard_pool_check`` through the master over gRPC as in phase 11,
    the worker's ledger beside this script, the in-process
    ``FakeKubeClient`` as the API (its scheduler places a pod in a few ms,
    so the card cannot show what a warm holder saves against a real
    scheduler's wait):
    a. two replicas with shard_count 2 on their renew loops at the default
       lease and renew interval, as the master daemon runs them (each
       stack's start timed); the node's owner stamps its epoch, at least 1,
       which must reach the worker's ledger, and still holds its shard after
       the flow; the worker with a warm pool of 1 at the default backoff, its
       holder Running: 3 live adds of 1 each adopt the holder
       (a hit, no miss; the span's pool_hit 1), a tenant child on the first
       pooled GPU runs phase 3's first forward through ``flash_fwd`` (its
       launches counted in the kernels line), each remove and the refill
       that restores the pool; then the pool drained and 3 cold adds (a
       miss each); the medians of both adds and their slave_pod_schedule
       spans beside phase 11's add;
    b. two such replicas, a lease each: /addgpu at the
       non-owner answers 307 to the owner (followed by
       ``rpc/http_failover.py``, it mounts); /batch/addgpu at the non-owner
       is proxied once to the owner (one trace over both replicas) and
       mounts, 3 times beside 3 direct batches; a forwarded batch at the
       non-owner answers NotOwner;
    c. a stale owner (leases of 0.3 s, every lease pass by hand, no renew
       loop): its live add held between its shard gate and its
       worker call while its lease writes are partitioned, the other
       replica's takeover at epoch + 1 (timed), the new owner's add mounts;
       the held add goes on and is fenced by the worker: 503 with
       Retry-After, nothing mounted, booked or written to the ledger (timed);
       the new owner's remove frees the GPU.
    Every case runs on the card's own GPU: without CAP_MKNOD the phase fails.
17. the fleet planes on a live hot-mount, ``entry.fleet_check`` through the
    master over gRPC as in phase 11, the master with a read token beside its
    mutate token and the worker's ops port on a free port:
    a. 3 live HTTP adds and removes of the card, each add's trace id kept;
    b. while the first is mounted, a tenant child (``--fleet-child``) on
       that GPU runs ``FLEET["STEPS"]`` full-width forwards through
       ``flash_fwd`` (its launches counted in the kernels line) and
       publishes its ``TenantTelemetry`` snapshot to the ops port's POST
       /tenant-telemetry with the mutate token;
    c. the collector's passes over the worker's CollectTelemetry, then, with
       the read token: /fleet (the node's mounts are the 3 adds, the total the
       nodes' sum), an exemplar naming an add in /fleet and in /metrics as
       OpenMetrics, /tenants (the child's tenant with its steps), /trace/<id>
       of the first add (complete, its worker spans federated through the
       remote store, its phases summing to its wall time within max(2 ms,
       5%)), /slo (each verdict the one its objective gives the phase's own
       adds, a breach with its GPUSLOBurnRate Event and audit record); the
       read token refused (401) on /addgpu and on POST /tenant-telemetry, and
       every read of both daemons refused without a token;
    d. a second worker on the same service without CollectTelemetry: a
       collector of its own scrapes its counters through the ops port, with
       no span and no tenant.
    The lines time a collection pass, one CollectTelemetry call with its
    payload's bytes, one POST /tenant-telemetry, one /trace/<id> assembly,
    the scrape fallback and one snapshot (its share of phase 11's add),
    medians of 3 on the host clock. Without CAP_MKNOD the phase fails.
18. health and recovery on a live hot-mount, ``entry.health_check``
    through the master over gRPC as in phase 11, the worker with a warm pool
    of 1 on its node and its ledger beside this script, the master with a
    read token, the in-process ``FakeKubeClient`` as the API:
    a. the node quarantined by hand (POST /health/quarantine/<node>, the
       mutate token); this process runs phase 3's first forward through
       ``flash_fwd`` (its launches counted in the kernels line) and holds
       the card; ``CanaryProber.probe_once`` mounts the H100 into the canary
       pod's target through the whole worker path, ProbeGPU answers it
       healthy with holder_count >= 1 (this process, which the canary pod's
       cgroup stand-in lists while the GPU is probed), and the canary's
       remove unmounts it, its ms beside phase 11's add; again with the
       GPU's node deleted from the target's /dev between the add and the
       probe: unhealthy ("injected device node vanished"), a canary failure;
    b. one collection pass after the quarantine carries ``quarantined`` to
       the worker: its warm pool drains (ready 0, the drained series + 1);
       the operator's release and the pool's refill; then two dropped
       attempts of a live add open the mount path's breaker, two passes
       score the node suspect and quarantined (``breaker_open``), and after
       the breaker's reset two clean canaries and the probation passes bring
       it to rehabilitating and back to healthy; /health/nodes and the
       flight recorder's ``health`` records show each transition with its
       signals;
    c. a worker's death: the node's worker becomes a child process
       (``testing/worker_process.py``, over a stand-in API server on the
       in-process API), a live add through the master and that process, the
       node quarantined by hand, the process killed with SIGKILL, its
       worker pod deleted and its Node NotReady in the API; ``check_once``
       passes until the recovery
       controller evacuates the node (the kill to the evacuation timed): the
       add's slave pod released, /recovery listing the evacuation, and the
       operator's release of the node refused (409, evacuated).
    Every case runs on the card's own GPU: without CAP_MKNOD the phase fails.
19. the elastic controller and the live migration on a live hot-mount,
    ``entry.elastic_migrate_check`` through the master over gRPC as in
    phase 11, the worker's ledger and the tenant's pack beside this script,
    the in-process ``FakeKubeClient`` as the API:
    a. PUT /intents/default/<pod> (1 GPU, min 1); a pass of the reconciler
       grows the pod through the slice coordinator, GET /intents shows it
       converged and ProbeGPU healthy; the GPU's node deleted from the
       target's /dev, ProbeGPU unhealthy ("injected device node vanished");
       the next pass heals: force-remove, the grow again (the only free GPU
       is the same H100, healthy at the host), ``tpumounter.io/chip-replaced``
       at generation 1, the ``elastic.heal`` record, the GPUChipReplaced
       Event, ``tpumounter_chips_healed_total`` + 1, and a
       ``torchside.watch_chip_replacements`` watcher on the pod fires once;
       the heal's ms beside phase 11's add;
    b. a tenant process at each end (``testing/migrate_tenant.py``, on the
       GPU through CUDA_VISIBLE_DEVICES, watching its pod over the stand-in
       API server): the source's runs phase 3's first forward through
       ``flash_fwd``; POST /migrate with the checkpoint: the source packs
       with ``HotResumable`` on the quiesce and saves the pack beside this
       script on the checkpoint, acking each (read through QuiesceStatus);
       the drain force-removes the H100 from the source, the remount mounts
       it into the destination, whose tenant loads and restores the pack on
       the resume, acks, and runs the same forward: its logits' sha256 equal
       to the source's (launches of both counted in the kernels line);
       verify probes; the journal ends succeeded, the intent of (a) is on
       the destination, its lock cleared, and /trace/<id> holds every phase
       under the /migrate edge; each phase's time and the downtime;
    c. ``migrate.phase.verify`` armed to fail, the GPU migrated back, no
       tenant (the acks time out at 0.3 s): the machine rolls back to the
       pod that holds the intent, the journal ends rolled-back with its
       GPUMigrationRolledBack Event, and the books, the ledger and the
       mounts agree;
    d. the defragmenter over HTTP on the same stack: GET /defrag (its
       gates open), POST /defrag/plan over the node's real capacity view (a
       host of one H100 is never blocked for a block of 4: a no-op plan, no
       blocked host, index 0), POST /defrag/run of that plan, which ends
       completed with 0 moves and stamps no capacity.recovered; the ms of
       each. A real move needs two hosts, which the card's machine does not
       have.
    Phase 15 also prints (b'): a second write partition lands while POST
    /migrate's machine waits in the quiesce; PUT /intents is refused (a
    user's CRUD is never deferred), the machine's journal persists (the
    phase's and the pause's, paused_for_api) defer with the GPU still on
    the source, and after the heal the flush lands them and the machine
    moves the GPU to the destination.
    Every case runs on the card's own GPU: without CAP_MKNOD the phase fails.
20. the capacity plane and a metered share on a live hot-mount,
    ``entry.capacity_share_check`` through the master over gRPC as in phase
    11, the master with a read token, the worker's ledger beside this
    script, the in-process ``FakeKubeClient`` as the API, the collector's
    passes by hand:
    a. a pass, then /capacity: the H100 free, ``nvidia-h100-80gb-1``
       admissible and tracked, no multi-host size tracked, the fleet's index
       0 (NVSwitch: a host's free GPUs are one block); the pass's ms beside
       phase 17's, and one capacity snapshot's share of phase 11's add;
    b. POST /shares books a decode tenant (weight 40, budget 64) on the
       H100's UUID; the worker's AddGPU with share_weight 40 and
       share_rate_budget 64 mounts it into its pod; the master's books, the
       ledger's share record and the policy engine's entry agree (invariant
       19; the userspace engine, since the card's machine has no bpf(2)),
       /shares shows the books, and the throttle decides alike in the engine
       and in the device program; a tenant child (``--mount-child``) on the
       shared GPU runs phase 3's first forward through ``flash_fwd`` (its
       launches counted in the kernels line);
    c. after a pass, /capacity reads the H100 held by the pod's slave pod,
       the headroom exhausted, the slice-feasibility counter advanced;
    d. a second pod's /addgpu answers 500, with one ``capacity.reject``
       record of cause exhaustion, on /timeline too;
    e. a re-grant at weight 60 is books-only, as the reference's: POST
       /shares on the tenant's own GPU answers 409, and ``ShareRegistry.add``
       changes the master's books in place while the ledger and the engine
       keep weight 40 (no route or RPC carries a re-grant to the worker), no
       program swap; the forced remove and DELETE /shares/<ns>/<pod> clear
       the three ledgers, and /capacity reads the H100 free again.
    Every case runs on the card's own GPU: without CAP_MKNOD the phase fails.
21. the autoscaler on a live hot-mount, ``entry.autoscale_check`` through the
    master over gRPC as in phase 11, the master with a read token, the
    worker's ops port, its ledger beside this script, the collector's passes
    by hand, the autoscaler's loop off: an HTTP add mounts the H100 into a
    pod and PUT /intents declares it (desired 1, min 1); a tenant child
    (``--autoscale-child``) on its UUID runs phase 3's weights at L 2048
    through ``flash_fwd`` in windows of B 1, 1, 2, 4 and 8, 40 steps each
    (more than the 32 token marks of ``TenantTelemetry``), each step a
    telemetry step at queue depth 64, publishes after each window and waits
    while the check runs a collection pass, which feeds the autoscaler's
    throughput model; GET /autoscale shows the tenant's fit ``ok`` with 4
    samples, and its r_max, b_half, rmse and utilization are printed with
    the card's name and power limit; two POST /autoscale/evaluate end in
    the reasons the reference's rule gives that fit (hysteresis, then
    infeasible at a utilization of 0.85 or more: the one GPU is held; else
    steady), the intent and the mount unchanged; POST /autoscale/pause makes
    evaluate answer 409 (paused) and the resume 200. The child's flash_fwd
    launches (2 layers a step) go into the kernels line.
22. the operator's verbs against the live stack, ``entry.cli_check``: each
    verb ``python -m gpumounter_tpu_torch.cli`` in a process of its own, the
    mutate token in TPUMOUNTER_AUTH_TOKEN and --read-token on the reads,
    every exit code asserted. `devices --busy` names CUDA's UUID at
    /dev/nvidia<minor> (major 195) with this process among its holders;
    `probe` reports 1 GPU, the identity source this script picked and this
    process's cgroup version; `add --num 1` mounts the H100 into the same
    kind of target as phase 10 and a tenant child (``--mount-child``) on
    that UUID runs phase 3's first forward through ``flash_fwd``; `audit`
    shows the add, `trace` and `why` of its trace id exit 0 (`why` naming
    the dominant phase), `trace` of 32 zeros 2; `capacity` 0 with the GPU
    held, `--accel-type nvidia-h100-80gb-1` as the reference's rule gives
    its verdict, `--accel-type v5litepod-4` 2; `add --num 2` 1 (500
    Insufficient), `--token ''` 1 (401); `remove` 0; `fleet`, `apihealth`
    and `shards` 0. Each verb's time from spawn to exit, the CLI's import
    alone (no torch, numpy or grpc loaded), and its add and remove beside
    the HTTP ones are printed.
23. the reference's jitted programs as the port runs them on the card: CUDA
    graphs that ``ops.graphs`` caches per key (``phase_graphs``), at full
    width, dense and MoE. 3 SGD steps of ``make_train_step`` (one capture)
    bit-equal, loss and every leaf, to its eager body (``capture=False``),
    the step's ms captured and eager by CUDA events, the first call with
    its capture by the host clock and the graph's replay alone (the step's
    device ms); ``forward`` at B 1, 2, 4 and 8 (L 2048): one capture each,
    logits of the first call and of the replays bit-equal to the eager
    forward's, each call's host ms (the call until the device is done) and
    the graph's device ms; greedy ``generate`` (4 prompts of 1536 + 512):
    the first call (two captures) and the second (none), each timed on the
    host clock and bit-equal to the eager loop's tokens; the memory the
    graphs and their buffers reserve. The captured runs' launches (counts
    set to 0 just before each, read just after, each equal to its eager
    run's) go into the kernels line.

Every tenant forward through ``_tenant_forward`` (phases 11, 11 d, 12, 14-16,
18, 20 and 22) is held, as phase 3's are, against the plain-attention forward of
the same tokens (LOGITS_RTOL_OF_MAX, NLL_ATOL), and its logits bit-equal to
phase 3's (their SHA-256); the count is printed before the kernels line.

A tenant child (``--<mode>-child``) imports only what its mode runs: the
model and its kernels, and what its mode adds; never ``entry`` and the
control plane behind it (``CHILD_MODE``). Each child's exec to CUDA ready is
printed.

The last lines are a JSON object per kernel (``{"kernels": [...]}``) and
``{"ok": true, "device": {...}}``, and the exit code is 0. A failing check
raises: the script prints which phase failed and why, and exits 1. Run
alone, without ``gpumounter_tpu_torch`` beside it, it says so and exits 2.
Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

#: the mode of a tenant child (``python3 chip_smoke.py --<mode>-child``, which
#: a phase starts), "" for the script itself. A child is a process start in
#: the script's budget, so it imports only what its mode runs: the model
#: and its kernels (every child), and what its mode adds; never the control
#: plane (``entry`` and everything behind it), the parallel steps or the
#: profiler's phases, which only the script runs.
CHILD_MODE = next((a for a in sys.argv[1:2] if a.endswith("-child")), "")

try:
    import gpumounter_tpu_torch  # noqa: F401
except ModuleNotFoundError as err:
    if err.name != "gpumounter_tpu_torch":
        raise
    print("chip_smoke: the package gpumounter_tpu_torch is not beside this script; "
          "run it from the root of the repository", file=sys.stderr)
    sys.exit(2)
from gpumounter_tpu_torch.models.probe import (TransformerConfig, _attend, _attend_decode,
                                               _decoder, _embed, _finish_block, _forward_impl,
                                               _picker, decode_step, forward, generate,
                                               generate_loop, init_params, local_heads,
                                               loss_fn, next_token_nll, prefill)
from gpumounter_tpu_torch.ops import flash_attention as fa, flash_decode as fd
from gpumounter_tpu_torch.ops.flash_attention import (_band_mask, _bwd_launch,
                                                      attention_bwd_plain,
                                                      attention_plain, flash_attention,
                                                      flash_attention_bwd_kernel,
                                                      flash_attention_kernel)
from gpumounter_tpu_torch.ops.flash_decode import (flash_decode_kernel,
                                                   flash_decode_plain)
from gpumounter_tpu_torch.ops.launches import TRAINING
from gpumounter_tpu_torch.ops.launches import launch_counts as _kernel_counts
from gpumounter_tpu_torch.ops.launches import reset_launch_counts as _reset_kernel_counts

if CHILD_MODE in ("", "--handoff-child"):
    import torch.nn.functional as F
    from gpumounter_tpu_torch.parallel.train_step import (gather_params, loss_and_grads,
                                                          make_train_step, shard_params,
                                                          make_train_step_optim,
                                                          sgd_update, step_collectives,
                                                          tree_leaves, tree_map, tree_names)
    from gpumounter_tpu_torch.torchside import (HotResumable, gpus_visible_in_dev, handoff,
                                                load_optimizer_state, optimizer_state_tree,
                                                refresh_devices, set_visibility_env,
                                                wait_for_gpus)
    from gpumounter_tpu_torch.torchside.visibility import HANDOFF_AT_ENV
if CHILD_MODE in ("", "--slice-child"):
    import torch.distributed as dist
    from gpumounter_tpu_torch.torchside.visibility import reinit_distributed
if CHILD_MODE in ("", "--v2-child"):
    from gpumounter_tpu_torch.testing import v2tenant
if CHILD_MODE in ("", "--fleet-child", "--autoscale-child"):
    from gpumounter_tpu_torch.torchside.telemetry import TenantTelemetry
if not CHILD_MODE:
    from gpumounter_tpu_torch.cgroup import detect_cgroup_version
    from gpumounter_tpu_torch.device.backend import NvidiaDeviceBackend
    from gpumounter_tpu_torch.entry import (ADD_TRACE, ADD_WORKER_SPANS, AUTOSCALE_QUEUE,
                                            AUTOSCALE_REFIT_RTOL, AUTOSCALE_STEPS,
                                            AUTOSCALE_WINDOWS,
                                            FLEET_SLO_WINDOW_S,
                                            MOE_ROUTE_GAP,
                                            OBS_COST_ITERS, ONE_PROCESS_LOSS_ATOL, REMOVE_TRACE,
                                            RING_TOL, SHARDED_LOSS_ATOL, SHARDED_PARAM_OF_MAX,
                                            SHARE, SHARE_REGRANT_WEIGHT,
                                            TRAIN_GRAD_ATOL, _check_equal_over, _masked_err,
                                            against_one_process, autoscale_check,
                                            busy_health_check,
                                            capacity_share_check, cgroup_v2_check,
                                            check_config, cli_check, CLI_SHAPE,
                                            CLI_UNKNOWN_SHAPE, degraded_check,
                                            durability_check,
                                            dryrun_multichip, elastic_migrate_check,
                                            fleet_check, grow_checks,
                                            has_cap_mknod, health_check,
                                            inventory_check, make_identity,
                                            master_check, moe_blocks_vs_plain, moe_check,
                                            shard_pool_check,
                                            mount_check, obs_check, pick_identity,
                                            route_flips, sharded_step_check, slice_check,
                                            tp_checks, train_check)
    from gpumounter_tpu_torch import native
    from gpumounter_tpu_torch.nsutil.ns import plain_helper_argv, run_helper, run_in_mount_ns
    from gpumounter_tpu_torch.parallel import collectives
    from gpumounter_tpu_torch.parallel.collectives import all_gather, all_reduce, ring_shift
    from gpumounter_tpu_torch.parallel.launch import run_ranks
    from gpumounter_tpu_torch.parallel.mesh import build_mesh, shard_qkv
    from gpumounter_tpu_torch.parallel.moe import (_route, init_moe_params, moe_ffn,
                                                   moe_ffn_plain)
    from gpumounter_tpu_torch.ops import _build
    from gpumounter_tpu_torch.ops import graphs
    from gpumounter_tpu_torch.ops.graphs import capture, clear_graphs
    from gpumounter_tpu_torch.parallel.pipeline import schedule_info
    from gpumounter_tpu_torch.parallel.pipeline_train import (make_pipeline_train_step,
                                                              shard_pipeline_params,
                                                              to_pipeline_params)
    from gpumounter_tpu_torch.parallel.ring_attention import ring_attention

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its operations over the bf16 tensor-core rate and its bytes
# (each input read once, each output written once) over the memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FULL = dict(B=4, H=8, L=2048, D=128)
# bf16 output: 1 ulp is 2^-8 relative; the kernel also rounds P to bf16
# before P·V (as the TPU kernel does) where the plain version keeps f32.
BF16_TOL = dict(atol=2e-2, rtol=1e-2)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# A decode output averages up to 32768 unit-normal V rows, so |o| can be far
# below BF16_TOL's atol: the bf16 cases are held to DECODE_ULPS_OF_MAX ulps
# (2^-8) of the output's max |value| instead, never looser than BF16_TOL.
# Then one 64-key tile left out of 32768 keys fails (checked on the CPU with
# the plain version: 251 of 4096 outputs beyond the limit).
DECODE_ULPS_OF_MAX = 4
LSE_ATOL = 1e-4  # lse is f32 from f32 scores on both sides
# Logits of the full forward: attention outputs that differ by ~1 bf16 ulp
# pass through two layers of bf16 matmuls and residual adds.
LOGITS_RTOL_OF_MAX = 2e-2
NLL_ATOL = 1e-3  # the mean over 4 x 2047 positions smooths those errors
NLL_ABOVE_UNIFORM = 0.5
# Serving at full width: prompts of 1536 tokens, decoding up to max_len.
SERVE = dict(B=4, T0=1536, N_NEW=512)
# Decode timings: the repo's decode bench shape (bench_flash_features.py:289)
# at three valid lengths, a GQA decode shape (group 8), and the serving shape.
DECODE_BENCH = dict(B=4, H=8, L_Q=8, D=128, L_MAX=32768, LENS=(1024, 8192, 32768))
DECODE_GQA = dict(H=32, H_KV=4, L_Q=1, L_MAX=32768, LEN=8192)
L2_COPIES = 4  # inputs cycled so that a timed launch finds its K/V outside L2
# Backward kernels against attention_bwd_plain, as a share of each gradient's
# max |value|. bf16: each gradient is rounded once to bf16 from f32
# accumulators (0.4% of max at most) and, as in the TPU kernel, p and ds are
# rounded to bf16 before their products where the plain version keeps f32;
# the first card run measured at most 0.8% of max. f32: the order of
# summation only (measured below 1e-6).
BWD_RTOL_OF_MAX = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Training at full width: 3 SGD steps on fresh 4 x 2048 batches.
TRAIN = dict(B=4, L=2048, STEPS=3, LR=1e-3)
# Grads of the bf16 weights through the kernels against those through the
# plain attention, per leaf, as a share of the leaf's max |grad|: attention
# grads that differ by up to 0.8% of max pass through two layers of bf16
# matmuls, rmsnorm and GELU backward, and every leaf is rounded to bf16.
GRAD_RTOL_OF_MAX = 5e-2
# The MoE configuration: the full-width config with the reference's 8
# experts (__graft_entry__.py:195-201).
MOE_EXPERTS = 8
# moe_ffn (batched products over every token) against moe_ffn_plain (each
# expert's own tokens): cuBLAS may sum the two shapes in other orders. bf16:
# both round the expert products to bf16, held to 4 bf16 ulps (2^-8 each)
# of the output's max |value|; f32 (no TF32): summation order, 1e-5 of max.
MOE_OUT_OF_MAX = {torch.bfloat16: 4 * 2**-8, torch.float32: 1e-5}
MOE_AUX_ATOL = 1e-5
# Teacher-forced MoE decode against the forward: the generated tokens are
# the model's own picks, so their NLL sits below log V and the forward's
# range does not apply. A routing flip (about 1% of positions a layer)
# changes its position's logits wholly; those logits spread s ~ 0.5, so a
# flip moves its position's NLL by about a nat and the mean by about 0.01.
MOE_SERVE_NLL_ATOL = 0.05
# Phase 7: 4 ranks on a 2 x 2 ("data", "model") mesh sharing the card over
# gloo; TIMED sharded steps a config timed on each rank, after the checks.
SHARDED = dict(SHAPE=(2, 2), BACKEND="gloo", SEED=200, TIMED=3)
# Phase 8: 4 ranks sharing the card over gloo, on (data, seq) meshes of
# 2 x 2 and 1 x 4 and a ("pipe",) mesh of 4; the pipelines run N_MICRO
# microbatches of the TRAIN batch (one row each), the interleaved one
# VIRTUAL chunks a rank; TIMED timed runs of each step a rank.
SEQ_PIPE = dict(WORLD=4, SEQ_SHAPES=((2, 2), (1, 4)), BACKEND="gloo", SEED=300, TIMED=3,
                N_MICRO=4, VIRTUAL=2)
# Phase 9: the hot-add that grows a job's mesh at full width, from OLD to
# NEW ("data", "model") ranks sharing the card over gloo (the data axis
# grows as well as model), STEPS AdamW steps in each world; then the
# reference's dryrun at the shape its __main__ runs (__graft_entry__.py:347), its
# 16-rank stretch included. TIMEOUT_S: each spawn's own limit.
# Both configs are grown in the same two worlds (``entry.grow_checks``).
GROW = dict(OLD=(1, 2), NEW=(2, 2), STEPS=(2, 2), BACKEND="gloo", TIMEOUT_S=300.0)
DRYRUN = dict(N=8, BACKEND="gloo", TIMEOUT_S=300.0)
# Phase 23: the cached programs at full width, RUNS timed calls of each;
# forward at each B of FORWARD_B (L 2048); the batches from numpy SEED.
GRAPHS = dict(RUNS=5, FORWARD_B=(1, 2, 4, 8), SEED=500)


def _card(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters runs, with CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn) -> tuple:
    """(ms, fn()): the call until the device is done, on the host clock."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, out


def _attention_pairs(l_q, l_k, causal=True, window=None):
    """(query, key) pairs one head attends: the causal band, L(L+1)/2 when
    L_q == L_k, cut to the window [p − window, p] when one is set."""
    if not causal:
        return l_q * l_k
    offset = l_k - l_q
    return sum(min(p, window) + 1 if window is not None else p + 1
               for p in range(offset, offset + l_q))


def _attention_bound_ms(b, h, l_q, l_k, d, itemsize, causal=True, h_kv=None, window=None):
    """Least time for the attention forward: 4·D operations per attended
    (query, key) pair against q and o (H heads) and k and v (H_kv heads)
    bytes. Returns (ms, what bounds it, the operations)."""
    flops = 4 * d * b * h * _attention_pairs(l_q, l_k, causal, window)
    nbytes = itemsize * d * b * (2 * h * l_q + 2 * (h_kv or h) * l_k)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops


def _bwd_bound_ms(b, h, h_kv, l_q, l_k, d, itemsize, products, n_out, causal=True, window=None):
    """Least time for one backward kernel: `products` products of 2·D
    operations per attended (query, key) pair (dq: S, dP, dQ; dk/dv: S, dP,
    dV, dK) against q, do, k, v, lse and Δ read once and its n_out
    outputs (dq: (B, H, L_q, D); dk, dv: (B, H_kv, L_k, D)) written once.
    Returns (ms, what bounds it, the operations)."""
    flops = 2 * products * d * b * h * _attention_pairs(l_q, l_k, causal, window)
    out_rows = b * h * l_q if n_out == 1 else 2 * b * h_kv * l_k
    nbytes = (itemsize * d * (2 * b * h * l_q + 2 * b * h_kv * l_k + out_rows)
              + 4 * 2 * b * h * l_q)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops


def _decode_bound_ms(b, h, h_kv, l_q, n, d, itemsize):
    """Least time for decode attention at valid length n (no window): the
    valid K/V region read once plus q and o, against 4·D operations per
    attended (query, key) pair — row i of l_q attends n − l_q + 1 + i keys.
    Returns (ms, what bounds it, the bytes)."""
    pairs = l_q * (n - l_q + 1) + l_q * (l_q - 1) // 2
    flops = 4 * d * b * h * pairs
    nbytes = itemsize * d * (2 * b * h_kv * n + 2 * b * h * l_q)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", nbytes


def _cycle(fns):
    """One callable that calls fns in turn, one per call."""
    state = {"i": 0}

    def call():
        fns[state["i"] % len(fns)]()
        state["i"] += 1
    return call


def _graph_ms(fns, calls: int = 20, replays: int = 5) -> float:
    """Device time per call of fns (taken in turn), without the host's
    launch overhead: `calls` calls are captured once in a CUDA graph (after
    one eager warm-up call) and the graph's replays timed with CUDA
    events."""
    call = _cycle(fns)
    graph = capture(lambda: [call() for _ in range(calls)])[0]
    return _time_ms(graph.replay, replays, warmup=1) / calls


def _profile_ms(fn, calls: int, names) -> dict:
    """Device ms a call of fn() spends in the kernels whose names hold each
    of `names`, by torch.profiler over `calls` calls."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for evt in prof.key_averages():
        for name in names:
            if evt.device_type == torch.autograd.DeviceType.CUDA and name in evt.key:
                out[name] += evt.self_device_time_total / 1e3 / calls
    return out


def _check_close(name, got, want, tol):
    """Raise unless |got − want| <= atol + rtol·|want| everywhere and got is
    finite; returns the max abs error."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    bad = diff > tol["atol"] + tol["rtol"] * want.float().abs()
    if not torch.isfinite(got).all() or bad.any():
        raise RuntimeError(f"{name}: max abs err {err} beyond atol "
                           f"{tol['atol']} + rtol {tol['rtol']}")
    return err


# A mangled kernel name: its length, then e.g. flash_bwd_dkv_kernel, then
# the template arguments (the anonymous namespace's own name also holds
# "flash_bwd_", after an underscore, not a digit).
_PTXAS_ENTRY = re.compile(r"Compiling entry function '\S*?\d(flash_(?:fwd|bwd|decode)_[a-z0-9_]+?_kernel)I(\w*?)EEv")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
# Warnings that mean the warp-specialised structure or the accumulator
# fences broke: ptxas dropped the register reallocation, or made the
# asynchronous products wait for each other.
_PTXAS_BROKEN = re.compile(r"setmaxnreg ignored|wgmma.*serialized|C7508", re.IGNORECASE)
PTXAS_REPORTED = ("flash_fwd", "flash_bwd", "flash_decode")
# The wgmma instances, which must not spill (the f32 scalar ones may).
_PTXAS_NO_SPILL = re.compile(r"ptxas (flash_fwd_tc|flash_bwd_dq|flash_bwd_dkv|flash_decode_tc)_kernel<")


def _ptxas_lines(log: str) -> list[str]:
    """One line per kernel instance of ptxas's -v report: its registers (the
    launch's cap; setmaxnreg moves them between warpgroups later) and its
    spills."""
    lines, name, spill = [], None, None
    for line in log.splitlines():
        if entry := _PTXAS_ENTRY.search(line):
            args = re.findall(r"L[ib](\d+)E?", entry.group(2) + "E")
            name = f"{entry.group(1)}<{', '.join(args)}>"
        elif name and (found := _PTXAS_SPILL.search(line)):
            spill = found.groups()
        elif name and spill and (found := _PTXAS_REGS.search(line)):
            lines.append(f"ptxas {name}: {found.group(1)} registers, spill stores "
                         f"{spill[0]} B, spill loads {spill[1]} B")
            name = spill = None
    return lines


def phase_build(card: str) -> float:
    """Build every kernel; beside the build, compile the wgmma sources once
    more with ptxas's -v report and print each instance's registers and
    spills, and ptxas's other notes. Fails on a warning that the
    warp-specialised structure broke. Returns the kernels' build time (s,
    host clock)."""
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reports = {}
    for name in PTXAS_REPORTED:
        report_so = _build.BUILD_DIR / f"ptxas-report-{name}.so"
        reports[name] = (report_so, subprocess.Popen(
            _build.nvcc_command(_build.CSRC / f"{name}.cu", report_so) + ["-Xptxas", "-v"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths = _build.build(sorted(src.stem for src in _build.CSRC.glob("*.cu")))
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s ({', '.join(p.name for p in paths.values())})", flush=True)
    for name, (report_so, report) in reports.items():
        log, _ = report.communicate()
        report_so.unlink(missing_ok=True)
        lines = _ptxas_lines(log)
        if report.returncode != 0 or not lines:
            raise RuntimeError(f"ptxas report of {name}.cu failed:\n{log[-3000:]}")
        notes = [line.strip() for line in log.splitlines()
                 if re.search(r"warning|\(C\d+\)", line)]
        print("\n".join(lines + [f"ptxas note ({name}.cu): {note}" for note in notes]), flush=True)
        if broken := [note for note in notes if _PTXAS_BROKEN.search(note)]:
            raise RuntimeError(f"{name}.cu: ptxas warns that the wgmma structure broke: {broken}")
        if spilled := [line for line in lines if _PTXAS_NO_SPILL.match(line)
                       and not line.endswith("spill stores 0 B, spill loads 0 B")]:
            raise RuntimeError(f"{name}.cu: wgmma instances spill: {spilled}")
    print(f"ptxas reports: {time.perf_counter() - t0:.1f} s", flush=True)
    return build_s


def phase_kernel_vs_plain(gen) -> float:
    """Each case runs the kernel and the plain version on the same inputs;
    returns the max abs error of the full-width causal case."""

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    b, h, l, d = FULL["B"], FULL["H"], FULL["L"], FULL["D"]
    cases = [  # (name, (B, H, H_kv, L_q, L_k, D), kwargs, dtype)
        ("causal B4 H8 L2048 D128", (b, h, h, l, l, d), dict(causal=True), torch.bfloat16),
        ("GQA H_kv=2", (b, h, 2, l, l, d), dict(causal=True), torch.bfloat16),
        ("window 255", (b, h, h, l, l, d), dict(causal=True, window=255), torch.bfloat16),
        ("window 255 + sinks 4", (b, h, h, l, l, d), dict(causal=True, window=255, sinks=4), torch.bfloat16),
        ("softcap 30", (b, h, h, l, l, d), dict(causal=True, softcap=30.0), torch.bfloat16),
        ("return_lse", (b, h, h, l, l, d), dict(causal=True, return_lse=True), torch.bfloat16),
        ("causal cross-length L_q=128 L_k=2048", (b, h, h, 128, l, d), dict(causal=True, return_lse=True), torch.bfloat16),
        ("D=32", (b, h, h, l, l, 32), dict(causal=True), torch.bfloat16),
        ("D=64", (b, h, h, l, l, 64), dict(causal=True), torch.bfloat16),
        ("ragged L=1000", (b, h, h, 1000, 1000, d), dict(causal=True), torch.bfloat16),
        ("non-causal L_q=300 L_k=700 D=64", (2, 4, 4, 300, 700, 64), dict(causal=False), torch.bfloat16),
        # The edges of the bf16 kernel's 128-row q tiles and 128-key k tiles.
        ("ragged L=129 + lse", (b, h, h, 129, 129, d), dict(causal=True, return_lse=True), torch.bfloat16),
        ("causal cross-length L_q=1 L_k=300", (b, h, h, 1, 300, d), dict(causal=True, return_lse=True), torch.bfloat16),
        ("causal cross-length L_q=100 L_k=300", (b, h, h, 100, 300, d), dict(causal=True, return_lse=True), torch.bfloat16),
        *[(f"window {w} L=1000", (b, h, h, 1000, 1000, d), dict(causal=True, window=w), torch.bfloat16)
          for w in (17, 127, 128, 129)],
        ("window 200 + sinks 130 L=1000", (b, h, h, 1000, 1000, d), dict(causal=True, window=200, sinks=130, return_lse=True), torch.bfloat16),
        ("GQA group 8 L=1000", (b, h, 1, 1000, 1000, d), dict(causal=True), torch.bfloat16),
        ("softcap 30 + lse", (b, h, h, l, l, d), dict(causal=True, softcap=30.0, return_lse=True), torch.bfloat16),
        ("f32 GQA window 17 + sinks 2 L=500 D=64", (2, 4, 2, 500, 500, 64), dict(causal=True, window=17, sinks=2, return_lse=True), torch.float32),
        # Ring attention's chunk steps at the full-width chunk (L 2048 over
        # 4 ranks): an earlier chunk whole, with lse.
        ("ring chunk non-causal L=512 + lse", (b, h, h, 512, 512, d), dict(causal=False, return_lse=True), torch.bfloat16),
        ("ring chunk non-causal GQA H_kv=2 L=512 + lse", (b, h, 2, 512, 512, d), dict(causal=False, return_lse=True), torch.bfloat16),
    ]
    full_err = None
    for name, (cb, ch, chk, lq, lk, cd), kw, dtype in cases:
        q = rand(cb, ch, lq, cd, dtype=dtype)
        k = rand(cb, chk, lk, cd, dtype=dtype)
        v = rand(cb, chk, lk, cd, dtype=dtype)
        got = flash_attention_kernel(q, k, v, **kw)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        want = attention_plain(q, k, v, **kw)
        if kw.get("return_lse"):
            (got, got_lse), (want, want_lse) = got, want
            lse_err = (got_lse - want_lse).abs().max().item()
            if not lse_err <= LSE_ATOL:
                raise RuntimeError(f"{name}: lse max abs err {lse_err} > {LSE_ATOL}")
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        err = _check_close(f"{name}: kernel vs plain", got, want, tol)
        lse_note = f", lse err {lse_err:.3g}" if kw.get("return_lse") else ""
        print(f"case {name}: max abs err {err:.3g} (atol {tol['atol']}, rtol {tol['rtol']}){lse_note}",
              flush=True)
        if full_err is None:
            full_err = err
    return full_err


def full_width_config(n_experts: int | None = None) -> TransformerConfig:
    return TransformerConfig(vocab=2048, d_model=1024, n_heads=8, n_layers=2,
                             d_ff=4096, max_len=FULL["L"], rope=True,
                             dtype=torch.bfloat16, n_experts=n_experts)


def phase_main_path(cfg, params, batches) -> int:
    """Forward on each batch through the kernel; returns its launch count."""
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    outs = [forward(params, tokens, cfg) for tokens in batches]
    torch.cuda.synchronize()
    launches = flash_attention_kernel.launches
    PHASE3_LOGITS["sha256"] = _logits_sha256(outs[0])
    want_launches = cfg.n_layers * len(batches)
    if launches != want_launches:
        raise RuntimeError(f"flash_fwd launched {launches} times on the main "
                           f"path, expected n_layers x batches = {want_launches}")
    for i, (tokens, logits) in enumerate(zip(batches, outs)):
        if logits.shape != (*tokens.shape, cfg.vocab) or not torch.isfinite(logits).all():
            raise RuntimeError(f"batch {i}: logits {tuple(logits.shape)} not "
                               f"finite of shape {(*tokens.shape, cfg.vocab)}")
        nll = next_token_nll(logits, tokens).item()
        # Random weights give near-uniform predictions: logits of std s put
        # the NLL about s²/2 above log(vocab) (s ~ 0.5 at this width).
        if not 0 <= nll - math.log(cfg.vocab) < NLL_ABOVE_UNIFORM:
            raise RuntimeError(f"batch {i}: next-token nll {nll} not within "
                               f"{NLL_ABOVE_UNIFORM} above log(vocab) = "
                               f"{math.log(cfg.vocab)}")
        plain = forward(params, tokens, cfg, attention=attention_plain)
        err = (logits - plain).abs().max().item()
        limit = LOGITS_RTOL_OF_MAX * plain.abs().max().item()
        nll_plain = next_token_nll(plain, tokens).item()
        if not (err <= limit and abs(nll - nll_plain) <= NLL_ATOL):
            raise RuntimeError(f"batch {i}: vs plain-attention forward: logits "
                               f"max abs err {err} (limit {limit}), nll {nll} "
                               f"vs {nll_plain} (limit {NLL_ATOL})")
        print(f"main path batch {i}: logits {tuple(logits.shape)} finite, nll "
              f"{nll:.4f} (log V {math.log(cfg.vocab):.4f}, plain-attention "
              f"forward {nll_plain:.4f}), logits vs plain-attention forward "
              f"max abs err {err:.3g} (limit {limit:.3g} = "
              f"{LOGITS_RTOL_OF_MAX} x max |logits|)", flush=True)
    print(f"main path: flash_fwd launches {launches} (n_layers {cfg.n_layers} "
          f"x batches {len(batches)})", flush=True)
    return launches


def phase_decode_vs_plain(gen) -> float:
    """flash_decode against flash_decode_plain, case by case; the length
    goes in as a CUDA int32 tensor and as an int, which must agree
    exactly, and a rerun must give the same bits. Returns the max abs
    error of the serving case at 2048."""

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    b, h, d = FULL["B"], FULL["H"], FULL["D"]
    serve = (b, h, h, 1, FULL["L"], d)
    cases = [  # (name, (B, H, H_kv, l_q, L_max, D), cache_len, kwargs, dtype, tail)
        *[(f"serving B4 H8 l_q1 D128 L_max2048 len {n}", serve, n, {}, torch.bfloat16, None)
          for n in (2048, 1, 37, 1537)],
        ("len 3000 clipped to L_max", serve, 3000, {}, torch.bfloat16, None),
        ("len 3 below l_q 8, clipped up", (b, h, h, 8, 2048, d), 3, {}, torch.bfloat16, None),
        ("tail 1e9 past len 1000", serve, 1000, {}, torch.bfloat16, 1e9),
        ("l_q 8 window 50", (b, h, h, 8, 2048, d), 1537, dict(window=50), torch.bfloat16, None),
        ("window 40 + sinks 8", serve, 1537, dict(window=40, sinks=8), torch.bfloat16, None),
        ("GQA H_kv 2", (b, h, 2, 1, 2048, d), 1537, {}, torch.bfloat16, None),
        ("MQA H_kv 1", (b, h, 1, 1, 2048, d), 1537, {}, torch.bfloat16, None),
        ("D 32", (b, h, h, 1, 2048, 32), 1537, {}, torch.bfloat16, None),
        ("D 64", (b, h, h, 1, 2048, 64), 1537, {}, torch.bfloat16, None),
        ("f32 GQA l_q 4 window 100 + sinks 3 D 64", (2, 8, 2, 4, 700, 64), 650,
         dict(window=100, sinks=3), torch.float32, None),
        # One block's 64 rows, then beyond them (two row chunks).
        ("GQA group 8 l_q 8 = 64 rows", (b, h, 1, 8, 2048, d), 1537, {}, torch.bfloat16, None),
        ("MQA H16 l_q 8 = 128 rows window 100 + sinks 4", (b, 16, 1, 8, 2048, d), 1537,
         dict(window=100, sinks=4), torch.bfloat16, None),
        ("f32 MQA H16 l_q 8 = 128 rows window 100 + sinks 3 D 64", (2, 16, 1, 8, 700, 64), 650,
         dict(window=100, sinks=3), torch.float32, None),
        # A length inside a 64-key tile: the tile's NaN slots arrive by TMA.
        ("NaN tail past len 1001", serve, 1001, {}, torch.bfloat16, float("nan")),
        ("bench shape len = L_max 32768", (b, h, h, DECODE_BENCH["L_Q"], DECODE_BENCH["L_MAX"], d),
         DECODE_BENCH["L_MAX"], {}, torch.bfloat16, None),
    ]
    serve_err = None
    for name, (cb, ch, chk, lq, lmax, cd), n, kw, dtype, tail in cases:
        q = rand(cb, ch, lq, cd, dtype=dtype)
        k = rand(cb, chk, lmax, cd, dtype=dtype)
        v = rand(cb, chk, lmax, cd, dtype=dtype)
        if tail is not None:
            k[:, :, n:] = tail
            v[:, :, n:] = tail
        got = flash_decode_kernel(q, k, v, torch.tensor([n], dtype=torch.int32, device="cuda"), **kw)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        by_int = flash_decode_kernel(q, k, v, n, **kw)
        if not torch.equal(got, by_int):
            raise RuntimeError(f"{name}: length as a tensor and as an int disagree")
        if not torch.equal(got, flash_decode_kernel(q, k, v, n, **kw)):
            raise RuntimeError(f"{name}: a rerun gave other bits")
        want = flash_decode_plain(q, k, v, n, **kw)
        tol = F32_TOL
        if dtype == torch.bfloat16:
            of_max = DECODE_ULPS_OF_MAX * 2**-8 * want.float().abs().max().item()
            tol = dict(BF16_TOL, atol=min(BF16_TOL["atol"], of_max))
        err = _check_close(f"{name}: kernel vs plain", got, want, tol)
        print(f"case flash_decode {name}: max abs err {err:.3g} (atol {tol['atol']:.3g}, "
              f"rtol {tol['rtol']}), tensor and int length equal, rerun bit-equal", flush=True)
        if serve_err is None:
            serve_err = err
    return serve_err


def phase_bwd_vs_plain(gen) -> tuple[float, float]:
    """flash_bwd's two kernels against attention_bwd_plain on the forward's
    cases: o and lse from the forward kernel, do random, and a nonzero lse
    cotangent in the cross-length case. Returns the max abs errors of dq
    and of dk/dv in the full-width causal case."""

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    b, h, l, d = FULL["B"], FULL["H"], FULL["L"], FULL["D"]
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, (B, H, H_kv, L_q, L_k, D), kwargs, dtype, with dlse)
        ("causal B4 H8 L2048 D128", (b, h, h, l, l, d), dict(causal=True), bf16, False),
        ("GQA H_kv=2", (b, h, 2, l, l, d), dict(causal=True), bf16, False),
        ("window 255", (b, h, h, l, l, d), dict(causal=True, window=255), bf16, False),
        ("window 255 + sinks 4", (b, h, h, l, l, d), dict(causal=True, window=255, sinks=4), bf16, False),
        ("softcap 30", (b, h, h, l, l, d), dict(causal=True, softcap=30.0), bf16, False),
        ("causal cross-length L_q=128 L_k=2048 + dlse", (b, h, h, 128, l, d), dict(causal=True), bf16, True),
        ("D=32", (b, h, h, l, l, 32), dict(causal=True), bf16, False),
        ("D=64", (b, h, h, l, l, 64), dict(causal=True), bf16, False),
        ("ragged L=1000", (b, h, h, 1000, 1000, d), dict(causal=True), bf16, False),
        ("non-causal L_q=300 L_k=700 D=64", (2, 4, 4, 300, 700, 64), dict(causal=False), bf16, False),
        # The edges of the bf16 kernels' tiles: blocks of 128 queries (dq)
        # and of 64 keys (dk/dv), tiles of 64 rows streamed against them.
        ("ragged L=129", (b, h, h, 129, 129, d), dict(causal=True), bf16, False),
        ("ragged L=300", (b, h, h, 300, 300, d), dict(causal=True), bf16, False),
        ("causal cross-length L_q=1 L_k=300", (b, h, h, 1, 300, d), dict(causal=True), bf16, False),
        ("causal cross-length L_q=100 L_k=300 + dlse", (b, h, h, 100, 300, d), dict(causal=True), bf16, True),
        *[(f"window {w} L=1000", (b, h, h, 1000, 1000, d), dict(causal=True, window=w), bf16, False)
          for w in (17, 127, 128, 129)],
        ("window 200 + sinks 130 L=1000", (b, h, h, 1000, 1000, d), dict(causal=True, window=200, sinks=130),
         bf16, False),
        ("window 50 + sinks 70 L=1000 D=64", (b, h, h, 1000, 1000, 64), dict(causal=True, window=50, sinks=70),
         bf16, False),
        ("GQA group 4 L=1000", (b, h, 2, 1000, 1000, d), dict(causal=True), bf16, False),
        ("GQA group 8 L=1000", (b, h, 1, 1000, 1000, d), dict(causal=True), bf16, False),
        ("negative scale L=1000 D=64", (b, h, h, 1000, 1000, 64), dict(causal=True, scale=-0.1), bf16, False),
        ("f32 GQA window 17 + sinks 2 L=500 D=64 + dlse", (2, 4, 2, 500, 500, 64),
         dict(causal=True, window=17, sinks=2), f32, True),
        # Ring attention's backward: the chunks merge through their lse, so
        # every chunk's lse cotangent is non-zero, on earlier chunks whole.
        ("ring chunk non-causal L=512 + dlse", (b, h, h, 512, 512, d), dict(causal=False), bf16,
         True),
        ("ring chunk non-causal GQA H_kv=2 L=512 + dlse", (b, h, 2, 512, 512, d),
         dict(causal=False), bf16, True),
    ]
    full = None
    for name, (cb, ch, chk, lq, lk, cd), kw, dtype, with_dlse in cases:
        q = rand(cb, ch, lq, cd, dtype=dtype)
        k = rand(cb, chk, lk, cd, dtype=dtype)
        v = rand(cb, chk, lk, cd, dtype=dtype)
        o, lse = flash_attention_kernel(q, k, v, return_lse=True, **kw)
        do = rand(cb, ch, lq, cd, dtype=dtype)
        dlse = rand(cb, ch, lq, dtype=f32) if with_dlse else None
        got = flash_attention_bwd_kernel(q, k, v, o, lse, do, dlse, **kw)
        torch.cuda.synchronize()  # a fault in the kernels surfaces here
        # No atomics and a fixed order of the group sum: the same bits again.
        if not all(map(torch.equal, got, flash_attention_bwd_kernel(q, k, v, o, lse, do, dlse, **kw))):
            raise RuntimeError(f"{name}: a rerun of the backward kernels gave other bits")
        want = attention_bwd_plain(q, k, v, o, lse, do, dlse, **kw)
        rtol = BWD_RTOL_OF_MAX[dtype]
        errs, limits = [], []
        for grad, g, w in zip(("dq", "dk", "dv"), got, want):
            err = (g.float() - w.float()).abs().max().item()
            limit = rtol * w.float().abs().max().item()
            if not (torch.isfinite(g).all() and err <= limit):
                raise RuntimeError(f"{name}: {grad} kernel vs plain max abs err {err} "
                                   f"(limit {limit} = {rtol} x max |{grad}|)")
            errs.append(err)
            limits.append(limit)
        print(f"case flash_bwd {name}: dq / dk / dv max abs err "
              f"{' / '.join(f'{e:.3g}' for e in errs)} (limits "
              f"{' / '.join(f'{x:.3g}' for x in limits)} = {rtol} x max |grad|), rerun bit-equal",
              flush=True)
        if full is None:
            full = (errs[0], max(errs[1:]))
    return full


def phase_train(cfg, params, batches) -> tuple[int, int, int]:
    """SGD steps through make_train_step, one per batch, with the counts
    set to 0 just before and read just after; then one batch's grads
    through the kernels against the grads through the plain attention, and
    train_check(). Returns the (flash_fwd, dq, dk/dv) launches."""
    step = make_train_step(cfg, TRAIN["LR"])
    bwd = flash_attention_bwd_kernel
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    bwd.dq_launches = bwd.dkv_launches = 0
    p, losses = params, []
    for tokens in batches:
        p, loss = step(p, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    counts = (flash_attention_kernel.launches, bwd.dq_launches, bwd.dkv_launches)
    want = cfg.n_layers * len(batches)
    if counts != (want,) * 3 or flash_decode_kernel.launches:
        raise RuntimeError(f"train steps launched flash_fwd / dq / dk/dv {counts} and "
                           f"flash_decode {flash_decode_kernel.launches} times, expected "
                           f"n_layers x steps = {want} each and 0")
    log_v = math.log(cfg.vocab)
    losses = [loss.item() for loss in losses]
    if not all(0 <= x - log_v < NLL_ABOVE_UNIFORM for x in losses):
        raise RuntimeError(f"train losses {losses} not within {NLL_ABOVE_UNIFORM} above "
                           f"log(vocab) = {log_v}")
    if not all(torch.isfinite(t).all() for t in tree_leaves(p)):
        raise RuntimeError("params after the train steps are not finite")
    print(f"training path: {len(batches)} SGD steps (lr {TRAIN['LR']}) on "
          f"{tuple(batches[0].shape)} tokens, losses {', '.join(f'{x:.4f}' for x in losses)} "
          f"(log V {log_v:.4f}); launches flash_fwd {counts[0]}, dq {counts[1]}, dk/dv "
          f"{counts[2]} (n_layers {cfg.n_layers} x {len(batches)} steps each)", flush=True)

    _, grads = loss_and_grads(params, batches[0], cfg)
    _, plain = loss_and_grads(params, batches[0], cfg, attention=attention_plain)
    bad, worst = [], (-1.0, "")
    for name, g, w in zip(tree_names(params), tree_leaves(grads), tree_leaves(plain)):
        err = (g.float() - w.float()).abs().max().item()
        peak = w.float().abs().max().item()
        share = err / peak if peak else math.inf
        print(f"training grads {name}: max abs err {err:.3g} vs plain-attention grads, "
              f"{share:.3g} of max |grad| {peak:.3g}", flush=True)
        if not (torch.isfinite(g).all() and err <= GRAD_RTOL_OF_MAX * peak):
            bad.append(name)
        worst = max(worst, (share, name))
    if bad:
        raise RuntimeError(f"grads of {bad} differ from the plain-attention grads by more "
                           f"than {GRAD_RTOL_OF_MAX} x max |grad|")
    print(f"training path: grads through the kernels vs plain attention, worst leaf "
          f"{worst[1]} at {worst[0]:.3g} of its max |grad| (limit {GRAD_RTOL_OF_MAX})", flush=True)
    result = train_check()
    print(f"train_check(): flagship dialect at d_head 32, loss {result['loss']:.4f}, "
          f"grads vs plain max abs err {result['max_grad_err']:.3g} (limit 5e-3)", flush=True)
    return counts


def phase_serving(cfg, params, prompt) -> tuple[int, int, torch.Tensor, torch.Tensor]:
    """Greedy generate with the counts set to 0 just before; then the
    teacher-forced and sampled checks. Returns (flash_fwd launches,
    flash_decode launches, tokens, forward's logits on the tokens)."""
    t0, n_new = prompt.shape[1], SERVE["N_NEW"]
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    tokens = generate(params, prompt, cfg, n_new)
    torch.cuda.synchronize()
    fwd, dec = flash_attention_kernel.launches, flash_decode_kernel.launches
    if (fwd, dec) != (cfg.n_layers, cfg.n_layers * (n_new - 1)):
        raise RuntimeError(f"generate launched flash_fwd {fwd} and flash_decode "
                           f"{dec} times, expected n_layers = {cfg.n_layers} and "
                           f"n_layers x (n_new - 1) = {cfg.n_layers * (n_new - 1)}")
    length = t0 + n_new
    if (tokens.shape != (prompt.shape[0], length) or not torch.equal(tokens[:, :t0], prompt)
            or tokens.min() < 0 or tokens.max() >= cfg.vocab):
        raise RuntimeError(f"generate returned {tuple(tokens.shape)} tokens in "
                           f"[{tokens.min().item()}, {tokens.max().item()}]")
    print(f"serving path: generate {tuple(prompt.shape)} + {n_new} -> "
          f"{tuple(tokens.shape)} tokens in range; flash_fwd launches {fwd} "
          f"(prefill, n_layers {cfg.n_layers}), flash_decode launches {dec} "
          f"(n_layers x {n_new - 1} steps)", flush=True)

    # Teacher forcing: the prefill's logits and one decode_step per
    # generated token give the logits at positions t0-1 .. length-2, which
    # the forward on the whole sequence gives too.
    ref = forward(params, tokens, cfg)
    logits, caches = prefill(params, prompt, cfg)
    steps = [logits]
    cur_len = torch.full((), t0, dtype=torch.int32, device="cuda")
    for p in range(t0, length - 1):
        steps.append(decode_step(params, caches, tokens[:, p], cur_len, cfg))
        cur_len = cur_len + 1
    got, want = torch.stack(steps, dim=1), ref[:, t0 - 1:length - 1]
    limit = LOGITS_RTOL_OF_MAX * want.abs().max().item()
    err = (got - want).abs().max().item()
    # Each greedy token is forward's argmax up to that tolerance (bf16 ties).
    chosen = want.gather(-1, tokens[:, t0:, None].long())[..., 0]
    gap = (want.amax(dim=-1) - chosen).max().item()
    if not (torch.isfinite(got).all() and err <= limit and gap <= limit):
        raise RuntimeError(f"teacher-forced decode vs forward: logits max abs err "
                           f"{err}, greedy token below forward's max by {gap} "
                           f"(limit {limit})")
    print(f"serving path: teacher-forced prefill + {length - 1 - t0} decode steps vs "
          f"forward at {length - t0} positions: logits max abs err {err:.3g}, greedy "
          f"tokens within {gap:.3g} of forward's max (limit {limit:.3g} = "
          f"{LOGITS_RTOL_OF_MAX} x max |logits|)", flush=True)

    _check_captured_loop(cfg, params, prompt, tokens, "serving path")
    return fwd, dec, tokens, ref


def _check_captured_loop(cfg, params, prompt, tokens, what) -> None:
    """generate's captured loop against generate_loop(capture=False), bit
    for bit: greedy (`tokens`, the counted run's) and seeded (a CUDA
    generator, T=1); seeded sampling reproducible per seed and different
    across seeds (one cached decoder, each seed's state copied in);
    torch.cuda.memory_allocated() after a greedy call (which evicts the
    sampled decoder, its generator's device state with it, for a greedy
    one) the same after each of two more, which replay it."""
    n_new = SERVE["N_NEW"]
    eager = generate_loop(params, prompt, cfg, n_new, capture=False)
    if not torch.equal(tokens, eager):
        raise RuntimeError(f"{what}: captured greedy tokens differ from the eager loop's at "
                           f"{int((tokens != eager).sum())} places")

    def sample(seed, captured=True):
        return generate_loop(params, prompt, cfg, n_new, torch.Generator(device="cuda").manual_seed(seed),
                             1.0, capture=captured)

    a, b, c, e = sample(1), sample(1), sample(2), sample(1, captured=False)
    if (not torch.equal(a, e) or not torch.equal(a, b) or torch.equal(a, c)
            or a.min() < 0 or a.max() >= cfg.vocab):
        raise RuntimeError(f"{what}: sampled tokens captured vs eager equal {torch.equal(a, e)}, "
                           f"reproducible {torch.equal(a, b)}, equal across seeds "
                           f"{torch.equal(a, c)}, in range {0 <= a.min() and a.max() < cfg.vocab}")
    del a, b, c, e, eager
    allocated = []
    for _ in range(3):
        if not torch.equal(generate(params, prompt, cfg, n_new), tokens):
            raise RuntimeError(f"{what}: a repeated greedy generate gave other tokens")
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
    if len(set(allocated)) != 1:
        raise RuntimeError(f"{what}: memory_allocated over repeated generate calls {allocated}")
    print(f"{what}: captured loop bit-equal to capture=False, greedy and sampled ({n_new} "
          f"tokens, T=1, a CUDA generator); sampled reproducible per seed, different across "
          f"seeds, in range; greedy reruns equal; memory_allocated {allocated[0]} B, the same "
          f"after each of two more calls", flush=True)


def phase_graph(cfg, params, tokens, ref, card) -> float:
    """Capture one greedy decode_step as a CUDA graph (a host sync inside
    the step would make the capture raise), replay it at two cache
    lengths by writing cur_len in place, and hold each replay against an
    eager step and, for a dense config, the forward (an MoE step may route
    a token otherwise than the forward, so its distance is printed only).
    Returns the replayed step's ms."""
    lens = (700, tokens.shape[1] - 8)
    _, caches = prefill(params, tokens[:, :lens[1]], cfg)
    token = tokens[:, lens[0]].clone()
    cur_len = torch.full((), lens[0], dtype=torch.int32, device="cuda")
    before = flash_decode_kernel.launches
    graph, replay, logits, _ = capture(lambda: decode_step(params, caches, token, cur_len, cfg))
    # The eager warm-up counts its launches; the capture's are taken out,
    # and a counted replay adds them once.
    if flash_decode_kernel.launches - before != cfg.n_layers:
        raise RuntimeError(f"warm-up and capture counted {flash_decode_kernel.launches - before} "
                           f"flash_decode launches, expected the warm-up's {cfg.n_layers}")
    before = flash_decode_kernel.launches
    replay()
    if flash_decode_kernel.launches - before != cfg.n_layers:
        raise RuntimeError(f"a counted replay added {flash_decode_kernel.launches - before} "
                           f"flash_decode launches, expected n_layers = {cfg.n_layers}")
    for n in lens:
        token.copy_(tokens[:, n])
        cur_len.fill_(n)
        before = flash_decode_kernel.launches
        graph.replay()
        torch.cuda.synchronize()
        if flash_decode_kernel.launches != before:
            raise RuntimeError("graph replay went through the wrapper")
        replayed = logits.clone()
        eager = decode_step(params, caches, tokens[:, n],
                            torch.full((), n, dtype=torch.int32, device="cuda"), cfg)
        err = _check_close(f"graph replay at length {n + 1} vs eager", replayed, eager, BF16_TOL)
        limit = LOGITS_RTOL_OF_MAX * ref[:, n].abs().max().item()
        ref_err = (replayed - ref[:, n]).abs().max().item()
        if cfg.n_experts is None and not ref_err <= limit:
            raise RuntimeError(f"graph replay at length {n + 1} vs forward: max abs "
                               f"err {ref_err} (limit {limit})")
        print(f"graph{' MoE' if cfg.n_experts else ''}: one captured decode_step replayed at "
              f"length {n + 1}: vs eager max abs err {err:.3g} (bit-equal "
              f"{torch.equal(replayed, eager)}), vs forward {ref_err:.3g} (limit {limit:.3g}"
              f"{'' if cfg.n_experts is None else ', not held: routing flips'}), no wrapper "
              f"launch during replay (a counted replay adds n_layers)", flush=True)
    ms = _time_ms(graph.replay, 50)
    print(f"time{' MoE' if cfg.n_experts else ''} decode_step as a replayed CUDA graph "
          f"B{tokens.shape[0]}: {ms:.4f} ms [{card}]", flush=True)
    return ms


def phase_timings(gen, cfg, params, tokens, card) -> dict:
    """flash_fwd and the PyTorch call for the same function, device time by
    graph replay (the wrapper's host time hidden) and eagerly per call, at
    the full-width shape, the prefill's and GQA with a window; the plain
    version at the full-width shape; then the forward. Returns the
    full-width shape's numbers."""
    shapes = [  # (name, (B, H, H_kv, L, D), window)
        ("B4 H8 L2048 D128 causal", (FULL["B"], FULL["H"], FULL["H"], FULL["L"], FULL["D"]), None),
        ("prefill B4 H8 L1536 D128 causal", (SERVE["B"], FULL["H"], FULL["H"], SERVE["T0"], FULL["D"]), None),
        ("GQA B4 H8 H_kv2 L2048 D128 window 255", (FULL["B"], FULL["H"], 2, FULL["L"], FULL["D"]), 255),
    ]
    out = None
    for name, (b, h, h_kv, l, d), window in shapes:
        q = torch.randn((b, h, l, d), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, h_kv, l, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))

        def kernel():
            return flash_attention_kernel(q, k, v, causal=True, window=window)

        if window is None:
            def library():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True)
        else:
            mask = _band_mask(l, l, window, 0, "cuda")

            def library():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        ms, library_ms = _graph_ms([kernel]), _graph_ms([library])
        eager_ms, eager_library_ms = _time_ms(kernel, 20), _time_ms(library, 20)
        bound_ms, bound_by, flops = _attention_bound_ms(b, h, l, l, d, q.element_size(),
                                                        h_kv=h_kv, window=window)
        print(f"time flash_fwd {name} bf16, device (graph-replayed): kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of bound {bound_ms:.4f} ms, "
              f"{bound_by}), sdpa {library_ms:.4f} ms; eager per call (host included): kernel "
              f"{eager_ms:.4f} ms, sdpa {eager_library_ms:.4f} ms [{card}]", flush=True)
        if out is None:
            plain_ms = _time_ms(lambda: attention_plain(q, k, v, causal=True), 5)
            print(f"time attention_plain {name} bf16: {plain_ms:.4f} ms [{card}]", flush=True)
            out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=library_ms)
        del q, k, v
    phase_forward_timing(cfg, params, tokens, card)
    return out


def phase_bwd_timings(gen, card) -> dict:
    """Each backward kernel alone (device time from graph replays), the
    whole wrapper eagerly, the plain backward, and SDPA's backward (its
    forward + backward through autograd, minus its forward, graph-replayed
    and eagerly): one library time for the pair of kernels. At the
    full-width shape, then with GQA H_kv 2 and window 255 (SDPA with the
    band mask). Returns the full-width shape's numbers."""
    b, h, l, d = FULL["B"], FULL["H"], FULL["L"], FULL["D"]
    shapes = [  # (name, H_kv, window)
        (f"B{b} H{h} L{l} D{d} causal", h, None),
        (f"GQA B{b} H{h} H_kv2 L{l} D{d} window 255", 2, 255),
    ]
    out = None
    for shape, h_kv, window in shapes:
        q, do = (torch.randn((b, h, l, d), generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((b, h_kv, l, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        o, lse = flash_attention_kernel(q, k, v, causal=True, window=window, return_lse=True)
        delta = (do.float() * o.float()).sum(dim=-1)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        band = dict(causal=True, scale=1.0 / math.sqrt(d), window=window, softcap=None, sinks=0)
        ms = {"dq": _graph_ms([lambda: _bwd_launch("dq", q, k, v, do, lse, delta, (dq,), **band)]),
              "dkv": _graph_ms([lambda: _bwd_launch("dkv", q, k, v, do, lse, delta, (dk, dv), **band)])}
        eager_ms = _time_ms(lambda: flash_attention_bwd_kernel(q, k, v, o, lse, do, causal=True,
                                                               window=window), 10)
        plain_ms = _time_ms(lambda: attention_bwd_plain(q, k, v, o, lse, do, causal=True, window=window),
                            3, warmup=1)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        if window is None:
            def sdpa():
                return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        else:
            mask = _band_mask(l, l, window, 0, "cuda")

            def sdpa():
                return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, enable_gqa=True)

        def sdpa_both():
            return torch.autograd.grad(sdpa(), (qg, kg, vg), do)

        sdpa_both_ms, sdpa_fwd_ms = _graph_ms([sdpa_both]), _graph_ms([sdpa])
        library_ms = sdpa_both_ms - sdpa_fwd_ms
        eager_library_ms = _time_ms(sdpa_both, 20) - _time_ms(sdpa, 20)
        times = {}
        for name, products, n_out in (("dq", 3, 1), ("dkv", 4, 2)):
            bound_ms, bound_by, flops = _bwd_bound_ms(b, h, h_kv, l, l, d, 2, products, n_out, window=window)
            print(f"time flash_bwd_{name} {shape} bf16, device (graph-replayed): kernel "
                  f"{ms[name]:.4f} ms ({flops / ms[name] / 1e9:.1f} TFLOP/s, {bound_ms / ms[name]:.1%} "
                  f"of bound {bound_ms:.4f} ms, {bound_by}) [{card}]", flush=True)
            times[name] = dict(ms=ms[name], plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=library_ms)
        print(f"time backward {shape} bf16: dq + dk/dv {ms['dq'] + ms['dkv']:.4f} ms, wrapper "
              f"(Δ + both kernels) eager {eager_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward, "
              f"device (graph-replayed) {library_ms:.4f} ms (forward + backward {sdpa_both_ms:.4f} ms − "
              f"forward {sdpa_fwd_ms:.4f} ms), eager {eager_library_ms:.4f} ms [{card}]", flush=True)
        out = out or times
        del q, k, v, do, o, lse, delta, dq, dk, dv, qg, kg, vg
    return out


def phase_train_profile(cfg, params, tokens, card, top: int = 15) -> None:
    """The device kernels of one eager SGD step by torch.profiler: name,
    calls and device ms of the `top` slowest, and their sum. Printed
    only."""
    step = make_train_step(cfg, TRAIN["LR"], capture=False)
    step(params, tokens)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        step(params, tokens)
        torch.cuda.synchronize()
    kernels = sorted(((evt.self_device_time_total / 1e3, evt.count, evt.key) for evt in prof.key_averages()
                      if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0),
                     reverse=True)
    total = sum(ms for ms, _, _ in kernels)
    print(f"profile of one{' MoE' if cfg.n_experts else ''} SGD step B{tokens.shape[0]} L{tokens.shape[1]}: "
          f"{len(kernels)} device kernels, "
          f"{total:.3f} ms of device time in all [{card}]", flush=True)
    for ms, calls, name in kernels[:top]:
        print(f"profile kernel {ms:.4f} ms, {calls} calls: {name[:140]}", flush=True)


def phase_train_timings(cfg, params, tokens, card) -> None:
    """The SGD step as make_train_step runs it on the card (one cached
    graph, the params and tokens copied in and the new params out) and as
    its eager body (capture=False), each by CUDA events over 5 calls; and
    the eager step with CUDA events between its forward (loss_fn), backward
    (autograd) and update."""
    step, eager = make_train_step(cfg, TRAIN["LR"]), make_train_step(cfg, TRAIN["LR"], capture=False)
    step_ms = _time_ms(lambda: step(params, tokens), 5, warmup=1)
    eager_ms = _time_ms(lambda: eager(params, tokens), 5, warmup=1)

    def split():
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        events[0].record()
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(leaves, tokens, cfg)
        events[1].record()
        grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
        events[2].record()
        sgd_update(params, tree_map(lambda _: next(grads), params), TRAIN["LR"])
        events[3].record()
        return events

    split()
    runs = [split() for _ in range(5)]
    torch.cuda.synchronize()
    fwd, bwd, upd = (sum(e[i].elapsed_time(e[i + 1]) for e in runs) / len(runs)
                     for i in range(3))
    print(f"time{' MoE' if cfg.n_experts else ''} train step B{tokens.shape[0]} L{tokens.shape[1]} "
          f"(SGD): captured {step_ms:.3f} ms, {tokens.numel() / (step_ms / 1e3):.0f} tokens/s; "
          f"eager {eager_ms:.3f} ms, {tokens.numel() / (eager_ms / 1e3):.0f} tokens/s; eager "
          f"split: forward {fwd:.3f} ms, backward {bwd:.3f} ms, update {upd:.3f} ms [{card}]",
          flush=True)


def phase_decode_timings(gen, card) -> dict:
    """flash_decode, its plain version and SDPA on the cache sliced to the
    length (``enable_gqa`` for a GQA shape), at the decode bench shape, a
    GQA shape and the serving shape, with the kernel's achieved TB/s and
    share of its bound, and the device time of its two kernels (the split
    kernel, the merge) by torch.profiler; each input set cycled L2_COPIES
    times so the K/V come from device memory. Returns the serving shape's
    numbers."""
    b, d = FULL["B"], FULL["D"]
    shapes = [  # (H, H_kv, l_q, L_max, lengths)
        (FULL["H"], FULL["H"], DECODE_BENCH["L_Q"], DECODE_BENCH["L_MAX"], DECODE_BENCH["LENS"]),
        (DECODE_GQA["H"], DECODE_GQA["H_KV"], DECODE_GQA["L_Q"], DECODE_GQA["L_MAX"], (DECODE_GQA["LEN"],)),
        (FULL["H"], FULL["H"], 1, FULL["L"], (FULL["L"],)),
    ]
    out = None
    for h, h_kv, l_q, l_max, lens in shapes:
        sets = [[torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                 for shape in ((b, h, l_q, d), (b, h_kv, l_max, d), (b, h_kv, l_max, d))]
                for _ in range(L2_COPIES)]
        for n in lens:
            length = torch.tensor([n], dtype=torch.int32, device="cuda")
            # imported here: it pulls in torch._dynamo, seconds of import time
            # that the handoff's children, which import this script, would pay
            from torch.nn.attention.bias import causal_lower_right
            mask = causal_lower_right(l_q, n) if l_q > 1 else None
            kernel = [lambda s=s: flash_decode_kernel(*s, length) for s in sets]
            library = [lambda s=s: F.scaled_dot_product_attention(
                s[0], s[1][:, :, :n], s[2][:, :, :n], attn_mask=mask, enable_gqa=h != h_kv)
                for s in sets]
            ms = _graph_ms(kernel)
            plain_ms = _graph_ms([lambda s=s: flash_decode_plain(*s, length) for s in sets], calls=4)
            library_ms = _graph_ms(library)
            eager_ms = _time_ms(_cycle(kernel), 40)
            eager_library_ms = _time_ms(_cycle(library), 40)
            split_ms, merge_ms = _profile_ms(_cycle(kernel), 20, ("flash_decode_tc_kernel",
                                                                  "flash_decode_merge")).values()
            bound_ms, bound_by, nbytes = _decode_bound_ms(b, h, h_kv, l_q, n, d, 2)
            print(f"time flash_decode B{b} H{h} H_kv{h_kv} l_q{l_q} D{d} L_max{l_max} len {n} "
                  f"bf16, device (graph-replayed): kernel {ms:.4f} ms ({nbytes / ms / 1e9:.3f} TB/s, "
                  f"{bound_ms / ms:.1%} of bound {bound_ms:.4f} ms, {bound_by}), plain "
                  f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms ({bound_ms / library_ms:.1%} of "
                  f"bound); eager per call (host included): kernel {eager_ms:.4f} ms, sdpa "
                  f"{eager_library_ms:.4f} ms; by torch.profiler: split kernel {split_ms:.4f} ms + "
                  f"merge {merge_ms:.4f} ms [{card}]", flush=True)
            out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=library_ms)
        del sets
    return out


def _runs(values) -> str:
    """The median of runs, then every run: work on the host (a capture, an
    eager loop) spreads widely between runs on a shared host."""
    return f"{statistics.median(values):.3f} ms (runs {', '.join(f'{x:.3f}' for x in values)})"


def phase_serving_timings(cfg, params, prompt, graph_step_ms, card) -> None:
    """The whole greedy generate, each call by the host's clock between two
    synchronizes: the first call for its key (the prefill's and the step's
    captures included) alone, then five calls that replay the cached
    prefill and step graphs; prefill alone (eagerly, and its device time by
    graph replay); then the first call's decode pieces as it runs them
    (``probe._decoder``, ``ops.graphs.capture``, the counted replays): the
    first step and the capture by the host's clock, and the replayed loop
    by CUDA events around its replays. The replayed graph of one
    decode_step (phase 4) is the step's device time, so its share of a step
    of the loop is how busy the loop keeps the card. Then the eager loop
    (generate_loop with capture=False) beside it."""
    n_new, b = SERVE["N_NEW"], prompt.shape[0]
    moe = " MoE" if cfg.n_experts else ""
    clear_graphs()
    first_gen, *gen = [_host_ms(lambda: generate(params, prompt, cfg, n_new))[0] for _ in range(6)]
    prefill_ms = _time_ms(lambda: prefill(params, prompt, cfg), 5, warmup=1)
    prefill_device_ms = _graph_ms([lambda: prefill(params, prompt, cfg)], calls=5)
    eager = [_host_ms(lambda: generate_loop(params, prompt, cfg, n_new, capture=False))[0]]
    eager_step_ms = (statistics.median(eager) - prefill_ms) / (n_new - 1)
    first, loop, reserved, enqueue, clocks = [], [], [], [], []
    for _ in range(3):
        begin, step, out = _decoder(params, prompt, cfg, n_new, _picker(None, None))
        begin()
        # What the capture's empty_cache (torch.cuda.graph's) may free.
        reserved.append(torch.cuda.memory_reserved() / 2**30)
        ms, (_, replay, _, _) = _host_ms(lambda: capture(step))
        first.append(ms)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        for _ in range(n_new - 2):
            replay()
        enqueue.append((time.perf_counter() - t) * 1e3)
        end.record()
        # Read while the card still runs the replays the host has queued.
        clocks.append(_card("clocks.sm,power.draw"))
        torch.cuda.synchronize()
        loop.append(start.elapsed_time(end))
        del begin, step, out, replay
    gen_ms, loop_ms = statistics.median(gen), statistics.median(loop)
    replay_ms = loop_ms / (n_new - 2)
    decode_ms = gen_ms - prefill_device_ms
    print(f"time{moe} serving B{b} prompt {prompt.shape[1]} n_new {n_new}: generate, the "
          f"first call for its key (the captures included) {first_gen:.3f} ms, the cached "
          f"graphs replayed {_runs(gen)}; prefill eager {prefill_ms:.3f} ms (device, "
          f"graph-replayed: {prefill_device_ms:.3f} ms); decode {decode_ms:.3f} ms (generate "
          f"less the replayed prefill) = {b * (n_new - 1) / (decode_ms / 1e3):.0f} decode "
          f"tokens/s over {n_new - 1} replayed steps [{card}]", flush=True)
    print(f"time{moe} a first call's decode: first step + capture {_runs(first)}, the capture alone ≈ "
          f"{statistics.median(first) - eager_step_ms:.3f} ms (less an eager step; the allocator "
          f"held {', '.join(f'{x:.2f}' for x in reserved)} GiB before each); replayed "
          f"loop {_runs(loop)} by CUDA events = {replay_ms:.4f} ms per step over {n_new - 2} "
          f"replays, {b / (replay_ms / 1e3):.0f} decode tokens/s; decode_step's replayed device "
          f"time {graph_step_ms:.4f} ms = {graph_step_ms / replay_ms:.1%} of a step of the loop "
          f"(card busy); the host queued the replays in {_runs(enqueue)}; SM clock and power "
          f"during the loops: {'; '.join(clocks)} [{card}]", flush=True)
    print(f"time{moe} eager loop (capture=False): generate {_runs(eager)}, "
          f"{eager_step_ms:.4f} ms per step, {b / (eager_step_ms / 1e3):.0f} decode tokens/s, "
          f"card busy at most {graph_step_ms / eager_step_ms:.1%} [{card}]", flush=True)


def phase_moe_ffn_vs_plain(gen) -> float:
    """moe_ffn against moe_ffn_plain on x (B·L, d_model) of the MoE path,
    in bf16 and in f32: the same expert for every token, the aux within
    MOE_AUX_ATOL and the outputs within MOE_OUT_OF_MAX of their max.
    Returns the bf16 case's max abs error."""
    t, d, ff = FULL["B"] * FULL["L"], 1024, 4096
    bf16_err = None
    for dtype in (torch.bfloat16, torch.float32):
        params = init_moe_params(torch.Generator().manual_seed(0), MOE_EXPERTS, d, ff, dtype, "cuda")
        x = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
        out, aux = moe_ffn(params, x)
        want, want_aux, want_idx = moe_ffn_plain(params, x)
        idx, _ = _route(params, x)
        per_expert = torch.bincount(idx, minlength=MOE_EXPERTS).tolist()
        err = (out.float() - want.float()).abs().max().item()
        limit = MOE_OUT_OF_MAX[dtype] * want.float().abs().max().item()
        aux_err = abs(aux.item() - want_aux.item())
        if not (torch.equal(idx, want_idx) and aux_err <= MOE_AUX_ATOL and err <= limit
                and torch.isfinite(out).all()):
            raise RuntimeError(f"moe_ffn vs moe_ffn_plain {dtype}: experts equal "
                               f"{torch.equal(idx, want_idx)}, aux err {aux_err} (limit "
                               f"{MOE_AUX_ATOL}), out max abs err {err} (limit {limit})")
        print(f"case moe_ffn vs moe_ffn_plain T{t} d{d} ff{ff} E{MOE_EXPERTS} {dtype}: same "
              f"expert for every token (tokens per expert {per_expert}), aux {aux.item():.6f} "
              f"err {aux_err:.3g}, out max abs err {err:.3g} (limit {limit:.3g} = "
              f"{MOE_OUT_OF_MAX[dtype]:.3g} x max |out|)", flush=True)
        bf16_err = err if bf16_err is None else bf16_err
        del params, x, out, want
    return bf16_err


def _print_blocks(what, records) -> None:
    """Print, and hold to the limits, the per-block records of
    moe_blocks_vs_plain (or of the serving check): the unflipped tokens'
    block output within LOGITS_RTOL_OF_MAX of its max, each grad within
    GRAD_RTOL_OF_MAX of its max."""
    for i, r in enumerate(records):
        limit = LOGITS_RTOL_OF_MAX * r["out_max"]
        n = r["flipped"].numel()
        line = (f"{what} block {i}: {int(r['flipped'].sum())} of {n} tokens routed to "
                f"another expert (largest top-1/top-2 gap among them {r['worst_gap']:.3g}, "
                f"limit {MOE_ROUTE_GAP}; router logits max abs diff {r['logit_err']:.3g}), "
                f"unflipped block output max abs err {r['out_err']:.3g} (limit {limit:.3g} = "
                f"{LOGITS_RTOL_OF_MAX} x max |out|)")
        bad = [] if r["out_err"] <= limit else ["output"]
        if "grads" in r:
            worst = max((err / peak if peak else math.inf, name)
                        for name, (err, peak) in r["grads"].items())
            bad += [name for name, (err, peak) in r["grads"].items()
                    if not err <= GRAD_RTOL_OF_MAX * peak]
            line += f"; grads worst {worst[1]} at {worst[0]:.3g} of its max (limit {GRAD_RTOL_OF_MAX})"
        print(line, flush=True)
        if bad:
            raise RuntimeError(f"{what} block {i}: {bad} beyond the limits: {line}")


def phase_moe_forward(cfg, params, batches) -> int:
    """The MoE forward on each batch with the counts set to 0 just before;
    then per batch the logits and NLL beside the plain-attention forward's
    (printed) and the block-by-block check (held). Returns its flash_fwd
    launches."""
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    outs = [forward(params, tokens, cfg) for tokens in batches]
    torch.cuda.synchronize()
    launches, want = flash_attention_kernel.launches, cfg.n_layers * len(batches)
    if launches != want or flash_decode_kernel.launches:
        raise RuntimeError(f"MoE forward launched flash_fwd {launches} and flash_decode "
                           f"{flash_decode_kernel.launches} times, expected {want} and 0")
    log_v = math.log(cfg.vocab)
    for i, (tokens, logits) in enumerate(zip(batches, outs)):
        nll = next_token_nll(logits, tokens).item()
        if (logits.shape != (*tokens.shape, cfg.vocab) or not torch.isfinite(logits).all()
                or not 0 <= nll - log_v < NLL_ABOVE_UNIFORM):
            raise RuntimeError(f"MoE batch {i}: logits {tuple(logits.shape)} finite "
                               f"{bool(torch.isfinite(logits).all())}, nll {nll} (log V {log_v})")
        plain = forward(params, tokens, cfg, attention=attention_plain)
        print(f"MoE forward batch {i}: logits {tuple(logits.shape)} finite, nll {nll:.4f} (log V "
              f"{log_v:.4f}; plain-attention forward {next_token_nll(plain, tokens).item():.4f}), "
              f"logits vs plain-attention forward max abs err {(logits - plain).abs().max().item():.3g} "
              f"({LOGITS_RTOL_OF_MAX} x max |logits| = "
              f"{LOGITS_RTOL_OF_MAX * plain.abs().max().item():.3g}; not held: routing flips)",
              flush=True)
        del plain
        _print_blocks(f"MoE forward batch {i}", moe_blocks_vs_plain(params, tokens, cfg))
    print(f"MoE forward: flash_fwd launches {launches} (n_layers {cfg.n_layers} x batches "
          f"{len(batches)})", flush=True)
    return launches


def phase_moe_train(cfg, params, batches) -> tuple[int, int, int]:
    """SGD steps of the MoE config with the counts set to 0 just before and
    read just after; the aux term in the loss; one batch's grads block by
    block (and whole-model, printed); then moe_check(). Returns the
    (flash_fwd, dq, dk/dv) launches."""
    step = make_train_step(cfg, TRAIN["LR"])
    bwd = flash_attention_bwd_kernel
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    bwd.dq_launches = bwd.dkv_launches = 0
    p, losses = params, []
    for tokens in batches:
        p, loss = step(p, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    counts = (flash_attention_kernel.launches, bwd.dq_launches, bwd.dkv_launches)
    want = cfg.n_layers * len(batches)
    if counts != (want,) * 3 or flash_decode_kernel.launches:
        raise RuntimeError(f"MoE train steps launched flash_fwd / dq / dk/dv {counts} and "
                           f"flash_decode {flash_decode_kernel.launches} times, expected {want} "
                           f"each and 0")
    log_v = math.log(cfg.vocab)
    losses = [loss.item() for loss in losses]
    if not all(0 <= x - log_v < NLL_ABOVE_UNIFORM for x in losses):
        raise RuntimeError(f"MoE train losses {losses} not within {NLL_ABOVE_UNIFORM} above "
                           f"log(vocab) = {log_v}")
    if not all(torch.isfinite(t).all() for t in tree_leaves(p)):
        raise RuntimeError("MoE params after the train steps are not finite")
    routers = {t.dtype for blk in p["blocks"] for key, t in blk.items() if key == "router"}
    if routers != {torch.float32}:
        raise RuntimeError(f"MoE routers after the SGD steps are {routers}, not float32")
    print(f"MoE training: {len(batches)} SGD steps (lr {TRAIN['LR']}) on "
          f"{tuple(batches[0].shape)} tokens, losses {', '.join(f'{x:.4f}' for x in losses)} "
          f"(log V {log_v:.4f}); launches flash_fwd {counts[0]}, dq {counts[1]}, dk/dv "
          f"{counts[2]} (n_layers {cfg.n_layers} x {len(batches)} steps each); routers float32",
          flush=True)

    # The aux term: loss_fn − the nll of the same forward's logits.
    tokens = batches[0]
    with torch.no_grad():
        logits, aux = _forward_impl(params, tokens, cfg, flash_attention)
        nll = next_token_nll(logits, tokens).item()
        loss = loss_fn(params, tokens, cfg).item()
    term = loss - nll
    if not (0.5 < aux.item() < 2 and abs(term - cfg.moe_aux_weight * aux.item()) <= 1e-5):
        raise RuntimeError(f"MoE loss {loss} − nll {nll} = {term}, expected moe_aux_weight "
                           f"{cfg.moe_aux_weight} x aux {aux.item()}")
    print(f"MoE training: loss_fn {loss:.6f} − next_token_nll {nll:.6f} = {term:.6g} = "
          f"{cfg.moe_aux_weight} x aux {aux.item():.6f} (mean over the layers)", flush=True)

    _, grads = loss_and_grads(params, tokens, cfg)
    _, plain = loss_and_grads(params, tokens, cfg, attention=attention_plain)
    worst = max(((g.float() - w.float()).abs().max().item() / w.float().abs().max().item(), name)
                for name, g, w in zip(tree_names(params), tree_leaves(grads), tree_leaves(plain)))
    print(f"MoE training: whole-model grads through the kernels vs plain attention, worst "
          f"leaf {worst[1]} at {worst[0]:.3g} of its max |grad| ({GRAD_RTOL_OF_MAX} held "
          f"block by block below: routing flips)", flush=True)
    del grads, plain
    _print_blocks("MoE training grads", moe_blocks_vs_plain(params, tokens, cfg, grads=True))
    result = moe_check()
    print(f"moe_check(): MoE flagship at d_head 32, loss {result['loss']:.4f}, block grads vs "
          f"plain max abs err {result['max_grad_err']:.3g} (limit 5e-3), flipped tokens per "
          f"layer {result['flipped']}; make_moe_step losses "
          f"{', '.join(f'{x:.6f}' for x in result['moe_step_losses'])}", flush=True)
    return counts


def _serving_blocks_vs_forward(cfg, params, tokens, t0) -> list[dict]:
    """Each block as the serving path runs it (the prefill's block on the
    first t0 positions, then one decode block a position against the
    cache) against the forward's block, at positions t0 − 1 .. T − 2, both
    on the forward's input to that layer, so a routing flip changes only
    its own position."""
    b, length = tokens.shape
    x, records = _embed(params, tokens, cfg), []
    for blk in params["blocks"]:
        xa_fwd = _attend(x, blk, cfg, flash_attention)[0]
        xa_pre, k, v = _attend(x[:, :t0], blk, cfg, flash_attention)
        shape = (b, cfg.kv_heads, cfg.max_len, cfg.d_head)
        kc, vc = (torch.zeros(shape, dtype=k.dtype, device="cuda") for _ in range(2))
        kc[:, :, :t0], vc[:, :, :t0] = k, v
        rows = [xa_pre[:, -1:]]
        for pos in range(t0, length - 1):
            cur_len = torch.full((), pos + 1, dtype=torch.int32, device="cuda")
            rows.append(_attend_decode(x[:, pos:pos + 1], blk, cfg, kc, vc, cur_len))
        xa_srv, xa_ref = torch.cat(rows, dim=1), xa_fwd[:, t0 - 1:length - 1]
        record = route_flips(xa_srv, xa_ref, blk)
        out_srv, out_ref = _finish_block(xa_srv, blk)[0], _finish_block(xa_ref, blk)[0]
        record.update(out_err=_masked_err(out_srv, out_ref, ~record["flipped"]),
                      out_max=out_ref.float().abs().max().item())
        records.append(record)
        x = _finish_block(xa_fwd, blk)[0]
    return records


@torch.no_grad()
def phase_moe_serving(cfg, params, prompt) -> tuple[int, int, torch.Tensor, torch.Tensor]:
    """Greedy generate of the MoE config with the counts set to 0 just
    before; the teacher-forced logits and NLL beside the forward's
    (printed; the NLL range held), the serving blocks against the
    forward's (held), seeded sampling. Returns (flash_fwd launches,
    flash_decode launches, tokens, forward's logits on the tokens)."""
    t0, n_new = prompt.shape[1], SERVE["N_NEW"]
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    tokens = generate(params, prompt, cfg, n_new)
    torch.cuda.synchronize()
    fwd, dec = flash_attention_kernel.launches, flash_decode_kernel.launches
    if (fwd, dec) != (cfg.n_layers, cfg.n_layers * (n_new - 1)):
        raise RuntimeError(f"MoE generate launched flash_fwd {fwd} and flash_decode {dec} "
                           f"times, expected {cfg.n_layers} and {cfg.n_layers * (n_new - 1)}")
    length = t0 + n_new
    if (tokens.shape != (prompt.shape[0], length) or not torch.equal(tokens[:, :t0], prompt)
            or tokens.min() < 0 or tokens.max() >= cfg.vocab):
        raise RuntimeError(f"MoE generate returned {tuple(tokens.shape)} tokens in "
                           f"[{tokens.min().item()}, {tokens.max().item()}]")
    print(f"MoE serving: generate {tuple(prompt.shape)} + {n_new} -> {tuple(tokens.shape)} "
          f"tokens in range; flash_fwd launches {fwd} (prefill), flash_decode launches {dec} "
          f"(n_layers x {n_new - 1} steps)", flush=True)

    ref = forward(params, tokens, cfg)
    logits, caches = prefill(params, prompt, cfg)
    steps = [logits]
    cur_len = torch.full((), t0, dtype=torch.int32, device="cuda")
    for pos in range(t0, length - 1):
        steps.append(decode_step(params, caches, tokens[:, pos], cur_len, cfg))
        cur_len = cur_len + 1
    got, want = torch.stack(steps, dim=1), ref[:, t0 - 1:length - 1]
    log_v = math.log(cfg.vocab)
    nll, nll_ref = (-torch.log_softmax(a, dim=-1).gather(-1, tokens[:, t0:, None].long()).mean().item()
                    for a in (got, want))
    limit = LOGITS_RTOL_OF_MAX * want.abs().max().item()
    chosen = want.gather(-1, tokens[:, t0:, None].long())[..., 0]
    off = int(((want.amax(dim=-1) - chosen) > limit).sum())
    if not (torch.isfinite(got).all() and abs(nll - nll_ref) <= MOE_SERVE_NLL_ATOL):
        raise RuntimeError(f"MoE teacher-forced decode: logits finite "
                           f"{bool(torch.isfinite(got).all())}, nll {nll} vs the forward's "
                           f"{nll_ref} (limit {MOE_SERVE_NLL_ATOL})")
    print(f"MoE serving: teacher-forced prefill + {length - 1 - t0} decode steps vs forward at "
          f"{length - t0} positions: logits max abs err {(got - want).abs().max().item():.3g} "
          f"({LOGITS_RTOL_OF_MAX} x max |logits| = {limit:.3g}; not held: routing flips), nll "
          f"{nll:.4f} vs forward's {nll_ref:.4f} (limit {MOE_SERVE_NLL_ATOL}; log V "
          f"{log_v:.4f}); {off} of "
          f"{chosen.numel()} greedy tokens below forward's max by more than that", flush=True)
    _print_blocks("MoE serving", _serving_blocks_vs_forward(cfg, params, tokens, t0))

    _check_captured_loop(cfg, params, prompt, tokens, "MoE serving")
    return fwd, dec, tokens, ref


# --- phase 6: the tenant's hot-mount side (torchside): the handoff ---

# The handoff's training: full-width batches of B 4 x L 2048 (numpy seeds
# SEED + step), AdamW (lr 1e-3, weight decay 1e-4), STEPS steps before the
# handoff and STEPS in the new image, then a greedy generate of PROMPTS
# prompts of T0 tokens + N_NEW; RUNS handoffs each, dense and MoE (RUNS was 3
# until the script neared its time limit).
HANDOFF = dict(B=4, L=2048, STEPS=3, RUNS=1, PROMPTS=2, T0=64, N_NEW=32, SEED=100)
HANDOFF_ADAMW = dict(lr=1e-3, weight_decay=1e-4)
HANDOFF_PARTS = ("pack", "save", "exec_to_cuda_ready", "load", "restore", "optimizer_load",
                 "first_step", "tenant_side")


def _handoff_batch(cfg, step: int) -> torch.Tensor:
    rng = np.random.default_rng(HANDOFF["SEED"] + step)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (HANDOFF["B"], HANDOFF["L"]))).cuda()


def _handoff_prompt(cfg) -> torch.Tensor:
    rng = np.random.default_rng(HANDOFF["SEED"] - 1)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (HANDOFF["PROMPTS"], HANDOFF["T0"]))).cuda()


def _adamw_step(cfg):
    return make_train_step_optim(cfg, lambda ps: torch.optim.AdamW(ps, **HANDOFF_ADAMW))


def _expected_counts(cfg, steps: int, generate_calls: int) -> dict:
    """Launches of `steps` train steps and `generate_calls` greedy generates."""
    n = cfg.n_layers
    return {"flash_fwd": n * (steps + generate_calls), "dq": n * steps, "dkv": n * steps,
            "flash_decode": n * (HANDOFF["N_NEW"] - 1) * generate_calls}


def _check_counts(what, got, want) -> None:
    if got != want:
        raise RuntimeError(f"{what}: launches {got}, expected {want}")


def _child_argv(spec: dict) -> list[str]:
    return [os.path.abspath(__file__), "--handoff-child", json.dumps(spec)]


def _handoff_child(spec: dict) -> None:
    """The tenant programs of phase 6, one stage per process image:

    enumerate (started with CUDA_VISIBLE_DEVICES=""): CUDA's count is 0 and
        stays 0 after set_visibility_env, torch.cuda.init() and
        refresh_devices() raise; hands off the full-width dense params,
        made on the CPU, to an image that sees the device;
    enumerated: wait_for_gpus(1), restore on cuda:0, one AdamW step;
    train: STEPS AdamW steps at full width, pack, hand off;
    resumed: wait_for_gpus(1), load, restore, STEPS more steps, generate;
        saves params, losses and tokens for the smoke to hold bit for bit
        against its own uninterrupted run, and prints its timings.

    Each prints one JSON line; any failure raises (exit code 1)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    stage, ckpt = spec["stage"], spec["ckpt"]
    cfg = full_width_config(spec.get("n_experts"))
    init_fn, step_fn = _adamw_step(cfg)
    if stage == "enumerate":
        report = {"CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES"),
                  "device_count": torch.cuda.device_count(),
                  "is_available": torch.cuda.is_available()}
        # is_available() read CUDA's own count: the enumeration is fixed now.
        set_visibility_env(visible_devices=spec["visible"])
        report["after_set_visibility_env"] = {
            "device_count": torch.cuda.device_count(),
            "is_available": torch.cuda.is_available()}
        for name, call in (("cuda_init", torch.cuda.init), ("refresh_devices", refresh_devices)):
            try:
                call()
            except RuntimeError as err:
                report[name] = f"raised: {err}"
            else:
                raise RuntimeError(f"{name}() worked in a process that enumerated no device")
        if (report["device_count"], report["is_available"],
                report["after_set_visibility_env"]["is_available"]) != (0, False, False):
            raise RuntimeError(f"enumeration not fixed at init: {report}")
        print(json.dumps({"enumerate": report}))
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        handoff(HotResumable.pack(params), ckpt, argv=_child_argv({**spec, "stage": "enumerated"}))
    elif stage == "enumerated":
        wait = wait_for_gpus(1, timeout_s=60.0)
        if wait["device_count"] != 1 or torch.cuda.device_count() != 1:
            raise RuntimeError(f"the new image sees {torch.cuda.device_count()} device(s), "
                               f"wait_for_gpus {wait}")
        (params,) = HotResumable.load(ckpt).restore("cuda")
        _reset_kernel_counts()
        params, opt, loss = step_fn(params, init_fn(params), _handoff_batch(cfg, 0))
        loss = loss.item()
        if not math.isfinite(loss):
            raise RuntimeError(f"the new image's step gave loss {loss}")
        print(json.dumps({"enumerated": {
            "CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "wait_for_gpus": wait, "device": torch.cuda.get_device_name(0),
            "param_device": str(params["embed"].device), "loss": loss,
            "launches": _kernel_counts()}}))
    elif stage == "train":
        params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        opt, losses = init_fn(params), []
        _reset_kernel_counts()
        for step in range(HANDOFF["STEPS"]):
            params, opt, loss = step_fn(params, opt, _handoff_batch(cfg, step))
            losses.append(loss)
        torch.cuda.synchronize()
        launches = _kernel_counts()
        t_pack = time.time()
        state = HotResumable.pack(params, optimizer_state_tree(opt), torch.stack(losses))
        t_packed = time.time()
        nbytes = sum(t.nbytes for t in _leaves(state.host_state))
        handoff(state, ckpt, argv=_child_argv({
            **spec, "stage": "resumed", "launches_before": launches, "pack_at": t_pack,
            "packed_at": t_packed, "bytes": nbytes}))
    elif stage == "resumed":
        t_exec, t_main = float(os.environ[HANDOFF_AT_ENV]), time.time()
        fds = _device_fds()  # the old image's device files, if exec kept any
        wait = wait_for_gpus(1, timeout_s=60.0)
        torch.cuda.init()
        fa._library(0), fa._bwd_library(0), fd._library(0)
        torch.cuda.synchronize()
        t_ready = time.time()
        state = HotResumable.load(ckpt)
        t_load = time.time()
        params, tree, losses = state.restore("cuda")
        torch.cuda.synchronize()
        t_restore = time.time()
        opt = init_fn(params)
        load_optimizer_state(opt, tree)
        t_opt = time.time()
        _reset_kernel_counts()
        params, opt, loss = step_fn(params, opt, _handoff_batch(cfg, HANDOFF["STEPS"]))
        torch.cuda.synchronize()
        t_step = time.time()
        more = [loss]
        for step in range(HANDOFF["STEPS"] + 1, 2 * HANDOFF["STEPS"]):
            params, opt, loss = step_fn(params, opt, _handoff_batch(cfg, step))
            more.append(loss)
        torch.cuda.synchronize()
        steady_ms = (time.time() - t_step) * 1e3 / (HANDOFF["STEPS"] - 1)
        tokens = generate(params, _handoff_prompt(cfg), cfg, HANDOFF["N_NEW"])
        torch.cuda.synchronize()
        launches = _kernel_counts()
        HotResumable.pack({"params": params, "losses": torch.cat([losses, torch.stack(more)]),
                           "tokens": tokens}).save(spec["out"])
        pack_at, packed_at = spec["pack_at"], spec["packed_at"]
        ms = {"pack": packed_at - pack_at, "save": t_exec - packed_at,
              "exec_to_cuda_ready": t_ready - t_exec, "load": t_load - t_ready,
              "restore": t_restore - t_load, "optimizer_load": t_opt - t_restore,
              "first_step": t_step - t_opt,
              "tenant_side": t_step - pack_at, "exec_to_main": t_main - t_exec,
              "wait_for_gpus": wait["total_ms"] / 1e3}
        print(json.dumps({"resumed": {
            "ms": {k: v * 1e3 for k, v in ms.items()}, "bytes": spec["bytes"],
            "steady_step_ms": steady_ms, "wait_for_gpus": wait,
            "launches_before": spec["launches_before"], "launches_after": launches,
            "device_fds_at_start": fds}}))
    else:
        raise RuntimeError(f"unknown handoff stage {stage!r}")


def _device_fds() -> int:
    """Open descriptors of this process on /dev/nvidia* files."""
    count = 0
    for name in os.listdir("/proc/self/fd"):
        try:
            count += os.readlink(f"/proc/self/fd/{name}").startswith("/dev/nvidia")
        except OSError:
            pass
    return count


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [] if tree is None else [tree]


def _run_child(spec: dict, env: dict | None = None) -> dict:
    """Run one handoff child to its end (both images); returns its JSON
    lines merged. Fails on a non-zero exit or on a missing line."""
    out = subprocess.run([sys.executable, *_child_argv(spec)], capture_output=True, text=True,
                         timeout=600, env=env)
    if out.returncode != 0:
        raise RuntimeError(f"handoff child {spec['stage']} exited {out.returncode}:\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    report = {}
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            report.update(json.loads(line))
    return report


def _filesystem(path: str) -> str:
    """The type of the filesystem that holds `path` (/proc/self/mounts)."""
    path, best = os.path.realpath(path), ("", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            _, mount, fstype = line.split()[:3]
            if (path == mount or path.startswith(mount.rstrip("/") + "/")) and len(mount) > len(best[0]):
                best = (mount, fstype)
    return best[1]


def _uninterrupted(cfg) -> tuple[dict, torch.Tensor, torch.Tensor, dict]:
    """The handoff's 2 x STEPS steps and its generate in this process,
    without a handoff: (params, losses, tokens, launches)."""
    init_fn, step_fn = _adamw_step(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    opt, losses = init_fn(params), []
    _reset_kernel_counts()
    for step in range(2 * HANDOFF["STEPS"]):
        params, opt, loss = step_fn(params, opt, _handoff_batch(cfg, step))
        losses.append(loss)
    tokens = generate(params, _handoff_prompt(cfg), cfg, HANDOFF["N_NEW"])
    torch.cuda.synchronize()
    return params, torch.stack(losses), tokens, _kernel_counts()


def _bit_equal(what, got, want) -> None:
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        diff = (got.float() - want.float()).abs().max().item() if got.shape == want.shape else None
        raise RuntimeError(f"{what}: not bit-equal to the uninterrupted run "
                           f"({got.dtype} {tuple(got.shape)} vs {want.dtype} "
                           f"{tuple(want.shape)}, max abs diff {diff})")


def phase_handoff(card: str) -> dict:
    """Phase 6: a. CUDA enumeration fixed at init, and the 0 -> 1 hot-add by
    handoff; b, c. RUNS handoffs of the full-width dense and MoE trainers,
    held bit for bit against this process's uninterrupted run, and the
    median time of each part. Returns the launches on this phase's path
    (the children's and the uninterrupted runs') and the median exec -> CUDA
    ready time of the new images, dense and MoE."""
    total = dict.fromkeys(("flash_fwd", "dq", "dkv", "flash_decode"), 0)
    ready_ms = {}

    def add(counts):
        for key in total:
            total[key] += counts[key]

    root = tempfile.mkdtemp(prefix="handoff-")
    try:
        fs = _filesystem(root)
        print(f"handoff: checkpoints under {root} ({fs}) [{card}]", flush=True)
        visible = os.environ.get("CUDA_VISIBLE_DEVICES") or "0"
        hidden = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        report = _run_child({"stage": "enumerate", "ckpt": os.path.join(root, "enum"),
                             "visible": visible}, env=hidden)
        first, new = report["enumerate"], report["enumerated"]
        _check_counts("handoff a: the new image's step", new["launches"],
                      _expected_counts(full_width_config(), 1, 0))
        if new["wait_for_gpus"]["device_count"] != 1 or new["param_device"] != "cuda:0":
            raise RuntimeError(f"handoff a: the new image {new}")
        add(new["launches"])
        print(f"handoff a (enumeration fixed at init): a process started with "
              f"CUDA_VISIBLE_DEVICES='' reads torch.cuda.device_count() {first['device_count']}, "
              f"is_available() {first['is_available']}; after set_visibility_env("
              f"visible_devices={visible!r}) torch.cuda.device_count() reads "
              f"{first['after_set_visibility_env']['device_count']} (NVML, from the environment) "
              f"but is_available() {first['after_set_visibility_env']['is_available']}, "
              f"torch.cuda.init() {first['cuda_init']!r}, refresh_devices() "
              f"{first['refresh_devices']!r}", flush=True)
        print(f"handoff a (0 -> 1 by handoff): the new image (CUDA_VISIBLE_DEVICES="
              f"{new['CUDA_VISIBLE_DEVICES']!r}) wait_for_gpus(1) {new['wait_for_gpus']}, "
              f"restored the full-width dense params onto {new['param_device']} "
              f"({new['device']}), one AdamW step loss {new['loss']:.4f}, launches "
              f"{new['launches']} [{card}]", flush=True)

        for name, n_experts in (("dense", None), ("MoE", MOE_EXPERTS)):
            cfg = full_width_config(n_experts)
            params, losses, tokens, launches = _uninterrupted(cfg)
            _check_counts(f"handoff {name}: the uninterrupted run", launches,
                          _expected_counts(cfg, 2 * HANDOFF["STEPS"], 1))
            add(launches)
            leaves = tree_leaves(params)
            n_params = sum(t.numel() for t in leaves)
            runs = []
            for run in range(HANDOFF["RUNS"]):
                spec = {"stage": "train", "n_experts": n_experts,
                        "ckpt": os.path.join(root, f"{name}-{run}"),
                        "out": os.path.join(root, f"{name}-{run}-out")}
                got = _run_child(spec)["resumed"]
                _check_counts(f"handoff {name}: the first image", got["launches_before"],
                              _expected_counts(cfg, HANDOFF["STEPS"], 0))
                _check_counts(f"handoff {name}: the new image", got["launches_after"],
                              _expected_counts(cfg, HANDOFF["STEPS"], 1))
                add(got["launches_before"])
                add(got["launches_after"])
                (out,) = HotResumable.load(spec["out"]).restore("cuda")
                _bit_equal(f"handoff {name} run {run}: losses", out["losses"], losses)
                _bit_equal(f"handoff {name} run {run}: tokens", out["tokens"], tokens)
                for i, (g, w) in enumerate(zip(tree_leaves(out["params"]), leaves, strict=True)):
                    _bit_equal(f"handoff {name} run {run}: param leaf {i}", g, w.detach())
                del out
                shutil.rmtree(spec["ckpt"])
                shutil.rmtree(spec["out"])
                runs.append(got)
            state_mb = runs[0]["bytes"] / 1e6
            print(f"handoff {name}: {n_params / 1e6:.1f}M params, state {state_mb:.1f} MB "
                  f"(params + AdamW moments, bf16{', f32 routers' if n_experts else ''}); "
                  f"{HANDOFF['RUNS']} runs, each 2 x {HANDOFF['STEPS']} AdamW steps on "
                  f"{HANDOFF['B']} x {HANDOFF['L']} and a greedy generate of "
                  f"{HANDOFF['PROMPTS']} x {HANDOFF['T0']} + {HANDOFF['N_NEW']}: losses "
                  f"{', '.join(f'{x:.4f}' for x in losses.tolist())}, the final params and "
                  f"the tokens bit-equal to the uninterrupted run in every run; launches "
                  f"a run: first image {runs[0]['launches_before']}, new image "
                  f"{runs[0]['launches_after']}; /dev/nvidia* descriptors open in the new "
                  f"image before it touched CUDA: {[r['device_fds_at_start'] for r in runs]}",
                  flush=True)
            for part in HANDOFF_PARTS + ("exec_to_main", "wait_for_gpus"):
                note = ""
                if part == "save":
                    rates = [r["bytes"] / r["ms"]["save"] / 1e6 for r in runs]
                    note = f", {statistics.median(rates):.3f} GB/s with the fsyncs"
                print(f"time handoff {name} {part}: {_runs([r['ms'][part] for r in runs])}"
                      f"{note} [{card}; checkpoint on {fs}]", flush=True)
            print(f"time handoff {name} steady step in the new image: "
                  f"{_runs([r['steady_step_ms'] for r in runs])} [{card}]", flush=True)
            ready_ms[name] = statistics.median(r["ms"]["exec_to_cuda_ready"] for r in runs)
            del params, leaves
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total, ready_ms


# --- phase 7: dp x tp and expert parallelism, 4 ranks sharing the card ---


def _one_process_step(cfg, params, tokens, device) -> tuple:
    """The one-process make_train_step on this rank's device: (new params,
    loss)."""
    new, loss = make_train_step(cfg, TRAIN["LR"])(
        tree_map(lambda t: t.to(device), params), tokens.to(device))
    return new, loss.item()


def _against_one_process(what, mesh, one_process, new_full, loss, loss_atol) -> dict:
    """Rank 0: new_full (whole params) and loss against the one-process
    step's (new params, loss) (``entry.against_one_process``)."""
    if mesh.rank != 0:
        return {}
    return against_one_process(what, new_full, loss, *one_process, loss_atol)


def _timed_ms(fn, runs: int) -> list[float]:
    """Host ms of `runs` calls of fn() on this rank, each from a barrier of
    every rank to its end, synchronized."""
    times = []
    for _ in range(runs):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _sharded_vs_one_process(name, cfg, mesh, params, tokens, new_local, loss) -> dict:
    """Rank 0: the one-process step on the same card, weights and tokens,
    against the sharded step's gathered new params (every rank gathers)."""
    gathered = gather_params(new_local, mesh, cfg)
    one = _one_process_step(cfg, params, tokens, mesh.device) if mesh.rank == 0 else None
    return _against_one_process(f"sharded {name} step", mesh, one, gathered, loss,
                                ONE_PROCESS_LOSS_ATOL[name])


def _sharded_grads_vs_plain(cfg, mesh, local, tokens) -> tuple[float, str]:
    """Each rank's shards of the grads through the kernels against those
    through the plain attention on the mesh, as a share of each leaf's max
    |grad| (GRAD_RTOL_OF_MAX, phase 3's limit), the kernels on this rank's
    H/tp q and H_kv/tp kv heads; returns the worst."""
    heads = []

    def recording(q, k, v, **kw):
        heads.append((q.shape[1], k.shape[1]))
        return flash_attention(q, k, v, **kw)

    _, grads = loss_and_grads(local, tokens, cfg, attention=recording, mesh=mesh)
    _, plain = loss_and_grads(local, tokens, cfg, attention=attention_plain, mesh=mesh)
    if heads != [local_heads(cfg, mesh)] * cfg.n_layers:
        raise RuntimeError(f"rank {mesh.rank}: attention ran on (q, kv) heads {heads}")
    worst = (0.0, "")
    for leaf, g, w in zip(tree_names(local), tree_leaves(grads), tree_leaves(plain)):
        share = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        if not (torch.isfinite(g).all() and share <= GRAD_RTOL_OF_MAX):
            raise RuntimeError(f"rank {mesh.rank}: sharded grads of {leaf} differ from the "
                               f"plain attention's by {share} of max |grad| > {GRAD_RTOL_OF_MAX}")
        worst = max(worst, (share, leaf))
    return worst


def _sharded_times(cfg, mesh, local, tokens) -> dict:
    """ms of TIMED sharded SGD steps on this rank (host clock from a
    barrier to the step's end, synchronized), of one gloo all-reduce of an
    activation over "model" (the payload of each f and g), and of the
    step's gradient sums over "data" (one all-reduce a leaf of this rank's
    shards)."""
    step = make_train_step(cfg, TRAIN["LR"], mesh)
    step(local, tokens)  # warm-up
    steps = _timed_ms(lambda: step(local, tokens), SHARDED["TIMED"])
    act = torch.ones((tokens.shape[0] // mesh.size("data"), tokens.shape[1], cfg.d_model),
                     dtype=cfg.dtype, device=mesh.device)
    reduces = _timed_ms(lambda: all_reduce(act, mesh, "model"), 5)
    grads = [t.clone() for t in tree_leaves(local)]
    sums = _timed_ms(lambda: [all_reduce(g, mesh, "data") for g in grads], SHARDED["TIMED"])
    return {"step_ms": steps, "all_reduce_ms": reduces, "all_reduce_bytes": act.nbytes,
            "grad_sums_ms": sums, "grad_bytes": sum(g.nbytes for g in grads)}


def _sharded_rank() -> dict:
    """One rank of phase 7; returns numbers and no tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = build_mesh(SHARDED["SHAPE"], device="cuda")
    out = {"rank": mesh.rank, "coords": mesh.coords, "device": str(mesh.device),
           "dialect": tp_checks(mesh)}
    # The dialect's two sharded steps (dense, MoE) are on the main path.
    launches = {k: v + out["dialect"]["moe_launches"][k]
                for k, v in out["dialect"]["launches"].items()}
    for name, n_experts in (("dense", None), ("MoE", MOE_EXPERTS)):
        cfg = full_width_config(n_experts)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens = torch.from_numpy(np.random.default_rng(SHARDED["SEED"]).integers(
            0, cfg.vocab, (TRAIN["B"], TRAIN["L"])))
        result = sharded_step_check(cfg, mesh, params, tokens, TRAIN["LR"])
        for k, v in result["launches"].items():
            launches[k] += v
        record = {"loss": result["loss"], "launches": result["launches"],
                  "collectives": result["collectives"],
                  **_sharded_vs_one_process(name, cfg, mesh, params, tokens,
                                            result["local"], result["loss"])}
        del result
        local = shard_params(params, mesh, cfg)
        if n_experts is None:
            record["grads_vs_plain"] = _sharded_grads_vs_plain(cfg, mesh, local, tokens)
        record["times"] = _sharded_times(cfg, mesh, local, tokens)
        out[name] = record
        del local
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def _parallel_rank() -> dict:
    """One rank of phases 7 and 8, which share one world: phase 7's steps,
    then phase 8's, so that the ranks start once for both."""
    sharded = _sharded_rank()
    gc.collect()
    torch.cuda.empty_cache()
    return {"sharded": sharded, "seq_pipe": _seq_pipe_rank()}


def phase_parallel(card: str) -> tuple[dict, dict]:
    """Phases 7 and 8 (see the module's docstring) in one world of 4 ranks,
    started once; returns each phase's training kernels' launches."""
    world = SHARDED["SHAPE"][0] * SHARDED["SHAPE"][1]
    if (world, SHARDED["BACKEND"]) != (SEQ_PIPE["WORLD"], SEQ_PIPE["BACKEND"]):
        raise RuntimeError(f"phases 7 and 8 share a world: {SHARDED} against {SEQ_PIPE}")
    torch.cuda.empty_cache()  # this process's cache, for the ranks' sake
    t0 = time.perf_counter()
    ranks = run_ranks(_parallel_rank, world, backend=SHARDED["BACKEND"], timeout_s=900.0)
    print(f"sharded and seq/pipeline: {world} ranks, one process each, all on "
          f"{ranks[0]['sharded']['device']}, over {SHARDED['BACKEND']}, one world for phases 7 "
          f"and 8: {time.perf_counter() - t0:.1f} s with the ranks' start", flush=True)
    return (phase_sharded(card, [r["sharded"] for r in ranks]),
            phase_seq_pipeline(card, [r["seq_pipe"] for r in ranks]))


def phase_sharded(card: str, ranks: list) -> dict:
    """Phase 7 (see the module's docstring): checks what the ranks
    reported, and returns the training kernels' launches on its main path
    (every rank's sharded steps)."""
    world = len(ranks)
    label = (f"{world} ranks sharing one H100 over {SHARDED['BACKEND']}, not a {world}-GPU "
             f"figure; mesh {SHARDED['SHAPE']} (data, model) [{card}]")
    print(f"sharded: {world} ranks on a {SHARDED['SHAPE']} (data, model) mesh, one process "
          f"each, all on {ranks[0]['device']}, over {SHARDED['BACKEND']} (NCCL refuses two "
          f"ranks on one device; gloo's all-reduce takes CUDA tensors by way of the host)",
          flush=True)
    total = dict.fromkeys(("flash_fwd", "dq", "dkv"), 0)
    for r in ranks:
        d = r["dialect"]
        print(f"sharded rank {r['rank']} {r['coords']}: train_check's dialect: loss "
              f"{d['loss']:.4f}, grads through the kernels vs the plain attention on the mesh "
              f"max abs err {d['max_grad_err']:.3g} (limit 5e-3), attention on (q, kv) heads "
              f"{d['heads']}, launches a step {d['launches']}, collectives {d['collectives']}; "
              f"MoE flagship loss {d['moe_loss']:.4f}, collectives {d['moe_collectives']}; "
              f"make_moe_step over (data, expert) losses "
              f"{', '.join(f'{x:.4f}' for x in d['moe_step_losses'])}", flush=True)
        for name in ("dense", "MoE"):
            rec = r[name]
            line = (f"sharded rank {r['rank']} full-width {name} SGD step: loss "
                    f"{rec['loss']:.4f}, launches {rec['launches']} (n_layers each), "
                    f"collectives {rec['collectives']}")
            if "loss_one_process" in rec:
                line += (f"; the one-process step on the card: loss "
                         f"{rec['loss_one_process']:.4f} (|diff| {rec['loss_err']:.3g}, limit "
                         f"{ONE_PROCESS_LOSS_ATOL[name]}), gathered params worst "
                         f"{rec['worst_param'][1]} at {rec['worst_param'][0]:.3g} of its max "
                         f"|value| (limit {SHARDED_PARAM_OF_MAX:.3g})")
            if "grads_vs_plain" in rec:
                share, leaf = rec["grads_vs_plain"]
                line += (f"; grads vs the plain attention on the mesh, worst {leaf} at "
                         f"{share:.3g} of its max |grad| (limit {GRAD_RTOL_OF_MAX}), the "
                         f"kernels on {full_width_config().n_heads // SHARDED['SHAPE'][1]} of "
                         f"{full_width_config().n_heads} heads")
            print(line, flush=True)
            t = rec["times"]
            print(f"time sharded {name} SGD step, rank {r['rank']}: {_runs(t['step_ms'])}; "
                  f"one gloo all-reduce of {t['all_reduce_bytes'] / 1e6:.1f} MB over model "
                  f"(8 a step): {_runs(t['all_reduce_ms'])}; the gradient sums over data "
                  f"({t['grad_bytes'] / 1e6:.1f} MB in one all-reduce a leaf): "
                  f"{_runs(t['grad_sums_ms'])} [{label}]", flush=True)
        for k in total:
            total[k] += r["launches"][k]
    for name in ("dense", "MoE"):
        if len({r[name]["loss"] for r in ranks}) != 1:
            raise RuntimeError(f"sharded {name}: the ranks' losses differ: "
                               f"{[r[name]['loss'] for r in ranks]}")
    print(f"sharded: launches on its main path (every rank's sharded steps): {total}",
          flush=True)
    return total


# --- phase 8: sequence and pipeline parallelism, 4 ranks sharing the card ---


def _kernel_counts_of(fn) -> tuple:
    """(fn()'s value, the training kernels' launches in it), the counts set
    to 0 just before and read just after."""
    _reset_kernel_counts(TRAINING)
    value = fn()
    torch.cuda.synchronize()
    return value, _kernel_counts(TRAINING)


def _grads_within(what, got, want, limit) -> float:
    """The worst of |got − want| over max |want|, tensor by tensor; raises
    beyond `limit` or where got is not finite."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        share = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        if not (torch.isfinite(g).all() and share <= limit):
            raise RuntimeError(f"{what}: {share} of max |grad| > {limit}")
        worst = max(worst, share)
    return worst


def _ring_vs_one_process(mesh) -> dict:
    """Ring attention over the mesh's seq axis at the full-width chunk
    shapes (B4 H8 L2048 D128 bf16, a chunk of L/n a rank) against
    flash_attention over the whole sequence on this rank: the output
    within BF16_TOL, dq, dk, dv of sum(out · do) within GRAD_RTOL_OF_MAX
    of each one's max |grad| (phase 3's limit); the launches of the
    rank's ring (c + 1 each at seq coordinate c); the times of the ring
    forward and backward, of one shift of its k and v chunks, and of one
    flash_attention call over the whole sequence, forward and backward."""
    gen = torch.Generator().manual_seed(SEQ_PIPE["SEED"])
    b, h, l, d = FULL["B"], FULL["H"], FULL["L"], FULL["D"]
    full = [torch.randn((b, h, l, d), generator=gen).to(mesh.device, torch.bfloat16)
            for _ in range(4)]
    q, k, v, do = (shard_qkv(t, mesh) for t in full)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out, fwd_launches = _kernel_counts_of(lambda: ring_attention(*leaves, mesh))
    grads, bwd_launches = _kernel_counts_of(lambda: torch.autograd.grad(out, leaves, do))
    whole = [t.clone().requires_grad_() for t in full[:3]]
    want = flash_attention(*whole, causal=True)
    want_grads = [shard_qkv(g, mesh) for g in torch.autograd.grad(want, whole, full[3])]
    err = _check_close(f"rank {mesh.rank}: ring attention vs flash_attention over the "
                       f"whole sequence", out, shard_qkv(want.detach(), mesh), BF16_TOL)
    grad_share = _grads_within(f"rank {mesh.rank}: ring attention grads", grads,
                               want_grads, GRAD_RTOL_OF_MAX)
    kv = (k.detach(), v.detach())
    with torch.no_grad():
        fwd_ms = _timed_ms(lambda: ring_attention(q, k, v, mesh), SEQ_PIPE["TIMED"])
    times = {"ring_fwd_ms": fwd_ms,
             "ring_fwd_bwd_ms": _timed_ms(
                 lambda: torch.autograd.grad(ring_attention(*leaves, mesh), leaves, do),
                 SEQ_PIPE["TIMED"]),
             "shift_ms": _timed_ms(lambda: ring_shift(kv, mesh, "seq"), 5),
             "shift_bytes": sum(t.nbytes for t in kv)}
    if mesh.rank == 0:  # the other ranks wait at the next collective
        with torch.no_grad():
            times["whole_fwd_ms"] = _time_ms(lambda: flash_attention(*full[:3], causal=True), 10)
        times["whole_fwd_bwd_ms"] = _time_ms(
            lambda: torch.autograd.grad(flash_attention(*whole, causal=True), whole, full[3]), 10)
    return {"max_abs_err": err, "grad_share": grad_share, "fwd_launches": fwd_launches,
            "bwd_launches": bwd_launches, "times": times}


def _replicas_equal(params: dict, mesh) -> None:
    """Raises unless every leaf is bit-equal on every rank of the mesh."""
    for axis in mesh.axis_names:
        _check_equal_over(params, mesh, axis)


def _seq_steps(mesh, shape) -> dict:
    """The full-width dense and MoE SGD steps over a (data, seq) mesh of
    this shape, window None: collectives as ``step_collectives``, each
    training kernel (c + 1)·n_layers times at seq coordinate c, replicas
    bit-equal on all ranks, and rank 0 holds them to the one-process step
    (``_against_one_process``); then TIMED steps on each rank."""
    out = {}
    for name, n_experts in (("dense", None), ("MoE", MOE_EXPERTS)):
        cfg = dataclasses.replace(full_width_config(n_experts), attn_parallel="seq")
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens = torch.from_numpy(np.random.default_rng(SEQ_PIPE["SEED"]).integers(
            0, cfg.vocab, (TRAIN["B"], TRAIN["L"])))
        local = shard_params(params, mesh, cfg)
        step = make_train_step(cfg, TRAIN["LR"], mesh)
        mesh.reset_counts()
        (new, loss), launches = _kernel_counts_of(lambda: step(local, tokens))
        counts = {"calls": dict(mesh.calls), "bytes": dict(mesh.bytes)}
        expected = step_collectives(cfg, mesh, local, tuple(tokens.shape))
        c = mesh.coord("seq")
        want_launches = dict.fromkeys(("flash_fwd", "dq", "dkv"), (c + 1) * cfg.n_layers)
        if counts != expected or launches != want_launches:
            raise RuntimeError(f"rank {mesh.rank} {shape} {name} seq step: collectives "
                               f"{counts}, expected {expected}; launches {launches}, expected "
                               f"{want_launches}")
        _replicas_equal(new, mesh)
        one = (_one_process_step(dataclasses.replace(cfg, attn_parallel="heads"), params,
                                 tokens, mesh.device) if mesh.rank == 0 else None)
        record = {"loss": loss.item(), "launches": launches, "collectives": counts,
                  **_against_one_process(f"{shape} {name} seq step", mesh, one, new,
                                         loss.item(), ONE_PROCESS_LOSS_ATOL[name])}
        del new, one
        record["step_ms"] = _timed_ms(lambda: step(local, tokens), SEQ_PIPE["TIMED"])
        out[name] = record
        del local
        torch.cuda.empty_cache()
    return out


def _shift_wait_ms(fn) -> tuple:
    """(fn()'s value, host ms this rank spent in the ring's point-to-point
    exchanges during it): every exchange is timed from a synchronize, so
    the time is the copies through the host and the wait for the peer, not
    the compute queued before it."""
    spent = [0.0]
    exchange = collectives._exchange

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = exchange(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += (time.perf_counter() - t0) * 1e3
        return got

    collectives._exchange = timed
    try:
        return fn(), spent[0]
    finally:
        collectives._exchange = exchange


def _pipeline_steps(mesh) -> dict:
    """GPipe (P 4, n_layers 4) and the interleaved schedule (P 4, v 2,
    n_layers 8) at full width, n_micro 4 on B4 L2048: each training kernel
    n_micro·v·(layers a chunk) times a step on every rank, the embedding
    bit-equal on all ranks, and rank 0 holds the gathered stages and the
    loss to the one-process step; then TIMED steps, and one more with the
    time spent in the shifts."""
    p = mesh.size("pipe")
    out = {}
    for name, v in (("GPipe", 1), ("interleaved", SEQ_PIPE["VIRTUAL"])):
        cfg = dataclasses.replace(full_width_config(), n_layers=p * v)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens = torch.from_numpy(np.random.default_rng(SEQ_PIPE["SEED"]).integers(
            0, cfg.vocab, (TRAIN["B"], TRAIN["L"])))
        local = shard_pipeline_params(to_pipeline_params(params, p, v), mesh)
        step = make_pipeline_train_step(mesh, cfg, SEQ_PIPE["N_MICRO"], TRAIN["LR"],
                                        n_virtual=v)
        (new, loss), launches = _kernel_counts_of(lambda: step(local, tokens))
        per = cfg.n_layers // (p * v)
        want_launches = dict.fromkeys(("flash_fwd", "dq", "dkv"), SEQ_PIPE["N_MICRO"] * v * per)
        if launches != want_launches:
            raise RuntimeError(f"rank {mesh.rank} {name} pipeline step: launches {launches}, "
                               f"expected {want_launches}")
        _check_equal_over({"embed": new["embed"], "blocks": []}, mesh, "pipe")
        stages = {k: torch.cat(all_gather(t, mesh, "pipe")) for k, t in new["stages"].items()}
        one = None
        if mesh.rank == 0:
            new_one, loss_one = _one_process_step(cfg, params, tokens, mesh.device)
            one = ({"embed": new_one["embed"],
                    "stages": to_pipeline_params(new_one, p, v)["stages"]}, loss_one)
        record = {"loss": loss.item(), "launches": launches,
                  "bubble_fraction": schedule_info(SEQ_PIPE["N_MICRO"], p, v)["bubble_fraction"],
                  **_against_one_process(f"{name} pipeline step", mesh, one,
                                         {"embed": new["embed"], "stages": stages},
                                         loss.item(), NLL_ATOL)}
        del new, stages, one
        record["step_ms"] = _timed_ms(lambda: step(local, tokens), SEQ_PIPE["TIMED"])
        dist.barrier()
        t0 = time.perf_counter()
        _, record["shift_wait_ms"] = _shift_wait_ms(lambda: step(local, tokens))
        torch.cuda.synchronize()
        record["shift_wait_step_ms"] = (time.perf_counter() - t0) * 1e3
        out[name] = record
        del local
        torch.cuda.empty_cache()
    return out


def _seq_pipe_rank() -> dict:
    """One rank of phase 8; returns numbers and no tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {shape: build_mesh(shape, ("data", "seq"), "cuda") for shape in SEQ_PIPE["SEQ_SHAPES"]}
    pipe = build_mesh((SEQ_PIPE["WORLD"],), ("pipe",), "cuda")
    ring_mesh = meshes[(1, SEQ_PIPE["WORLD"])]
    out = {"rank": pipe.rank, "device": str(pipe.device), "ring": _ring_vs_one_process(ring_mesh)}
    torch.cuda.empty_cache()
    out["seq"] = {shape: _seq_steps(mesh, shape) for shape, mesh in meshes.items()}
    out["pipeline"] = _pipeline_steps(pipe)
    launches = dict.fromkeys(("flash_fwd", "dq", "dkv"), 0)
    for record in [*(r for steps in out["seq"].values() for r in steps.values()),
                   *out["pipeline"].values()]:
        for k in launches:
            launches[k] += record["launches"][k]
    out["launches"] = launches
    return out


def phase_seq_pipeline(card: str, ranks: list) -> dict:
    """Phase 8 (see the module's docstring): prints what the ranks
    measured, and returns the training kernels' launches on its main path
    (every rank's dp x sp and pipeline steps)."""
    world = len(ranks)
    label = (f"{world} ranks sharing one H100 over {SEQ_PIPE['BACKEND']}, not a {world}-GPU "
             f"figure [{card}]")
    print(f"seq/pipeline: {world} ranks, one process each, all on {ranks[0]['device']}, over "
          f"{SEQ_PIPE['BACKEND']} (point-to-point by way of host buffers: gloo's send and recv "
          f"take no CUDA tensor)", flush=True)
    total = dict.fromkeys(("flash_fwd", "dq", "dkv"), 0)
    b, h, l, d = FULL["B"], FULL["H"], FULL["L"], FULL["D"]
    for r in ranks:
        ring, t = r["ring"], r["ring"]["times"]
        print(f"seq/pipeline rank {r['rank']}: ring attention B{b} H{h} L{l} (4 chunks of "
              f"{l // world}) D{d} bf16 vs flash_attention over the whole sequence: max abs err "
              f"{ring['max_abs_err']:.3g} (atol {BF16_TOL['atol']}, rtol {BF16_TOL['rtol']}), "
              f"dq/dk/dv worst {ring['grad_share']:.3g} of max |grad| (limit "
              f"{GRAD_RTOL_OF_MAX}); launches forward {ring['fwd_launches']}, backward "
              f"{ring['bwd_launches']}", flush=True)
        print(f"time ring attention a layer, rank {r['rank']}: forward {_runs(t['ring_fwd_ms'])}, "
              f"forward + backward {_runs(t['ring_fwd_bwd_ms'])}; one shift of its k and v "
              f"chunks ({t['shift_bytes'] / 1e6:.1f} MB) {_runs(t['shift_ms'])} [{label}]",
              flush=True)
        if "whole_fwd_ms" in t:
            print(f"time flash_attention over the whole sequence (one process, B{b} H{h} L{l} "
                  f"D{d}, device time): forward {t['whole_fwd_ms']:.3f} ms, forward + backward "
                  f"{t['whole_fwd_bwd_ms']:.3f} ms [{card}]", flush=True)
        for shape, steps in r["seq"].items():
            for name, rec in steps.items():
                line = (f"seq/pipeline rank {r['rank']} {shape} (data, seq) full-width {name} SGD "
                        f"step: loss {rec['loss']:.4f}, launches {rec['launches']}, collectives "
                        f"{rec['collectives']}")
                if "loss_one_process" in rec:
                    line += (f"; the one-process step: loss {rec['loss_one_process']:.4f} (|diff| "
                             f"{rec['loss_err']:.3g}, limit {ONE_PROCESS_LOSS_ATOL[name]}), params "
                             f"worst {rec['worst_param'][1]} at {rec['worst_param'][0]:.3g} of "
                             f"its max |value| (limit {SHARDED_PARAM_OF_MAX:.3g})")
                print(line, flush=True)
                print(f"time seq {shape} {name} SGD step, rank {r['rank']}: "
                      f"{_runs(rec['step_ms'])} [{label}]", flush=True)
        for name, rec in r["pipeline"].items():
            line = (f"seq/pipeline rank {r['rank']} {name} pipeline step (P {world}, n_micro "
                    f"{SEQ_PIPE['N_MICRO']}): loss {rec['loss']:.4f}, launches {rec['launches']}")
            if "loss_one_process" in rec:
                line += (f"; the one-process step: loss {rec['loss_one_process']:.4f} (|diff| "
                         f"{rec['loss_err']:.3g}, limit {NLL_ATOL}), params worst "
                         f"{rec['worst_param'][1]} at {rec['worst_param'][0]:.3g} of its max "
                         f"|value| (limit {SHARDED_PARAM_OF_MAX:.3g})")
            print(line, flush=True)
            print(f"time {name} pipeline step, rank {r['rank']}: {_runs(rec['step_ms'])}; "
                  f"schedule_info bubble fraction {rec['bubble_fraction']:.3f} against "
                  f"{rec['shift_wait_ms']:.1f} ms in the shifts of a "
                  f"{rec['shift_wait_step_ms']:.1f} ms step "
                  f"({rec['shift_wait_ms'] / rec['shift_wait_step_ms']:.3f}; each exchange "
                  f"timed from a synchronize) [{label}]", flush=True)
        for k in total:
            total[k] += r["launches"][k]
    for what, losses in (
            *((f"seq {shape} {name}", [r["seq"][shape][name]["loss"] for r in ranks])
              for shape in SEQ_PIPE["SEQ_SHAPES"] for name in ("dense", "MoE")),
            *((f"{name} pipeline", [r["pipeline"][name]["loss"] for r in ranks])
              for name in ("GPipe", "interleaved"))):
        if len(set(losses)) != 1:
            raise RuntimeError(f"{what}: the ranks' losses differ: {losses}")
    print(f"seq/pipeline: launches on its main path (every rank's dp x sp and pipeline steps): "
          f"{total}", flush=True)
    return total


# --- phase 9: the mesh-growing hot-add and the multichip dryrun ---


def _add_launches(total: dict, launches: dict) -> None:
    for k in total:
        total[k] += launches[k]


def _expect_launches(what: str, got: dict, n: int) -> None:
    want = dict.fromkeys(("flash_fwd", "dq", "dkv"), n)
    if got != want:
        raise RuntimeError(f"{what}: launches {got}, expected {want}")


def phase_grow(card: str) -> dict:
    """Phase 9a: ``entry.grow_checks`` at full width, dense and MoE in the
    same two worlds, from GROW["OLD"] to GROW["NEW"] ranks on the card: its
    checks (restored shards bit-equal, gathered again bit-equal, the first
    step against one process), the launches of every rank's steps
    (n_layers a step), and the host-clock parts of the hot-add. Returns
    the training kernels' launches on its main path (every rank's steps in
    both worlds)."""
    total = dict.fromkeys(("flash_fwd", "dq", "dkv"), 0)
    old, new = GROW["OLD"], GROW["NEW"]
    n_old, n_new = math.prod(old), math.prod(new)
    label = (f"ranks sharing one H100 over {GROW['BACKEND']}, not a multi-GPU figure; "
             f"{old} -> {new} (data, model) [{card}]")
    names = ("dense", "MoE")
    cfgs = [full_width_config(None), full_width_config(MOE_EXPERTS)]
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        result = grow_checks(old, new, cfgs, [os.path.join(root, n) for n in names],
                             backend=GROW["BACKEND"], steps=GROW["STEPS"],
                             batch=(TRAIN["B"], TRAIN["L"]), timeout_s=GROW["TIMEOUT_S"])
        seconds = time.perf_counter() - t0
        fs = _filesystem(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"grow: dense then MoE in one world of {n_old} ranks, then one of {n_new}; "
          f"{seconds:.1f} s with both worlds' start; the new world's start (spawn to its last "
          f"rank's entry) {result['start_s'] * 1e3:.0f} ms [{label}]", flush=True)
    for name, cfg, worlds in zip(names, cfgs, result["configs"], strict=True):
        for world, n_steps in (("old", GROW["STEPS"][0]), ("new", GROW["STEPS"][1])):
            for r in worlds[world]:
                _expect_launches(f"grow {name}, {world} world, rank {r['rank']}", r["launches"],
                                 cfg.n_layers * n_steps)
                _add_launches(total, r["launches"])
        a, b = worlds["old"][0], worlds["new"][0]
        one = b["one_process"]
        print(f"grow {name}: {n_old} -> {n_new} ranks, full width, AdamW; losses before the "
              f"hot-add {', '.join(f'{x:.4f}' for x in a['losses'])}, after "
              f"{', '.join(f'{x:.4f}' for x in b['losses'])} (every rank's equal); restored "
              f"params and both moments bit-equal to shard_params of the packed state, gathered "
              f"again bit-equal; the first step against one process from the same state: loss "
              f"{one['loss_one_process']:.4f} (|diff| {one['loss_err']:.3g}, limit "
              f"{ONE_PROCESS_LOSS_ATOL[name]}), its update with the step's gradients worst "
              f"{one['worst_param'][1]} at {one['worst_param'][0]:.3g} of its max |value| "
              f"(limit {SHARDED_PARAM_OF_MAX:.3g}); launches a rank {a['launches']} then "
              f"{b['launches']}", flush=True)
        times = {"pack (with its gather), rank 0": a["times"]["pack"],
                 f"save, rank 0 ({fs})": a["times"]["save"]}
        for r in worlds["new"]:
            for part in ("load", "restore", "optimizer"):
                times[f"{part}, rank {r['rank']}"] = r["times"][part]
        parts = "; ".join(f"{k} {_runs(v)}" for k, v in times.items())
        firsts = ", ".join(f"{r['times']['first_step']:.1f}" for r in worlds["new"])
        print(f"time grow {name}: {parts}; the first step, ranks 0-{n_new - 1}: {firsts} ms "
              f"[{label}]", flush=True)
    print(f"grow: launches on its main path (every rank's steps in both worlds): {total}",
          flush=True)
    return total


def phase_dryrun(card: str) -> dict:
    """Phase 9b: ``entry.dryrun_multichip(DRYRUN["N"])`` on the card, the
    reference's sections on N ranks, then the 16-rank stretch over the H100
    plan; each section's loss and errors against its limit, the launches
    of each kernel per rank (each section's count checked), and the time
    of each spawn with the ranks' start. Returns the launches on its main
    path (every rank's sharded steps, as phases 7-8 count theirs)."""
    torch.cuda.empty_cache()
    n = DRYRUN["N"]
    result = dryrun_multichip(n, backend=DRYRUN["BACKEND"], timeout_s=DRYRUN["TIMEOUT_S"])
    total = dict.fromkeys(("flash_fwd", "dq", "dkv"), 0)
    n_layers = check_config().n_layers
    dp, sp = result["seq_shape"]
    secs = result["seconds"]
    print(f"dryrun: {n} ranks, then the stretch's {result['plan'].total_gpus} "
          f"({result['plan'].mesh_shape} (data, model): {result['plan'].num_hosts} hosts of "
          f"{result['plan'].gpus_per_host} {result['plan'].accel_type}), all on one card over "
          f"{DRYRUN['BACKEND']}; sections {secs['sections']:.1f} s, stretch {secs['stretch']:.1f} s, "
          f"each with its ranks' start [{card}]", flush=True)
    for r in result["sections"]:
        tp, seq, pipe = r["tp"], r["seq"], r["pipeline"]
        _expect_launches(f"dryrun tp_checks rank {r['rank']}", tp["launches"], n_layers)
        _expect_launches(f"dryrun MoE flagship rank {r['rank']}", tp["moe_launches"], n_layers)
        _expect_launches(f"dryrun seq_checks rank {r['rank']}", seq["launches"],
                         (r["rank"] % sp + 1) * n_layers)
        line = (f"dryrun rank {r['rank']}: tp_checks loss {tp['loss']:.4f}, grads through the "
                f"kernels vs the plain attention max abs err {tp['max_grad_err']:.3g} (limit "
                f"{TRAIN_GRAD_ATOL}), (q, kv) heads {tp['heads'][0]}, MoE flagship loss "
                f"{tp['moe_loss']:.4f}, make_moe_step losses "
                f"{', '.join(f'{x:.4f}' for x in tp['moe_step_losses'])}, launches "
                f"{tp['launches']} + {tp['moe_launches']}; seq_checks on ({dp}, {sp}) loss "
                f"{seq['loss']:.4f} vs unsharded |diff| {seq['loss_err']:.3g} (limit "
                f"{SHARDED_LOSS_ATOL}), ring {seq['ring_err']:.3g} and ring-flash "
                f"{seq['ring_flash_err']:.3g} (limit {RING_TOL['atol']}), launches {seq['launches']}")
        for k in total:
            total[k] += tp["launches"][k] + tp["moe_launches"][k] + seq["launches"][k]
        if pipe is not None:
            _expect_launches(f"dryrun pipeline_checks rank {r['rank']}", pipe["launches"],
                             pipe["n_micro"] * 2)
            line += (f"; pipeline_checks ({result['pipe_stages']} stages, n_micro "
                     f"{pipe['n_micro']}) loss {pipe['loss']:.4f} vs unsharded |diff| "
                     f"{pipe['loss_err']:.3g} (limit {SHARDED_LOSS_ATOL}), GPipe err "
                     f"{pipe['gpipe_err']:.3g} (limit 1e-6), launches {pipe['launches']}")
            _add_launches(total, pipe["launches"])
        print(line, flush=True)
    for r in result["stretch"]:
        _expect_launches(f"dryrun stretch rank {r['rank']}", r["launches"], n_layers)
        _add_launches(total, r["launches"])
        print(f"dryrun stretch rank {r['rank']} {r['coords']}: loss {r['loss']:.4f} vs unsharded "
              f"{r['loss_unsharded']:.4f} (|diff| {r['loss_err']:.3g}, limit "
              f"{SHARDED_LOSS_ATOL}), launches {r['launches']}, collectives "
              f"{r['collectives']['calls']}", flush=True)
    print(f"dryrun: launches on its main path (every rank's sharded steps): {total}", flush=True)
    return total


# --- phase 10: the hot-mount on the card (the control plane's one-node flows) ---

# add_gpu and remove_gpu are timed so many times (the median is printed),
# on the card and on a fake host of FAKE_GPUS (the H100 node of topology.py).
MOUNT = dict(REPEATS=3, FAKE_GPUS=8)


def _mount_child(spec: dict) -> None:
    """The tenant of phase 10, started with CUDA_VISIBLE_DEVICES=<the UUID
    the worker assigned>: CUDA's one device must be that GPU; then one
    full-width probe forward (phase 3's weights and first batch) through
    flash_fwd. Prints one JSON line; a failure raises (exit code 1)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.init()
    props = torch.cuda.get_device_properties(0)
    torch.cuda.synchronize()
    t_ready = time.time()
    uuid = f"GPU-{props.uuid}"
    if uuid != spec["uuid"] or torch.cuda.device_count() != 1:
        raise RuntimeError(f"CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r}: "
                           f"{torch.cuda.device_count()} device(s), device 0 is {uuid}, the "
                           f"worker assigned {spec['uuid']}")
    print(json.dumps({"mount_child": {"ready_at": t_ready, "uuid": uuid,
                                      "imports": _imports_at_ready(), **_tenant_forward()}}))


def _imports_at_ready() -> dict:
    """What a child had imported when CUDA was ready: its modules, the
    port's among them, and whether torch._dynamo was one."""
    names = list(sys.modules)
    return {"modules": len(names),
            "port": sum(1 for n in names if n.startswith("gpumounter_tpu_torch")),
            "dynamo": "torch._dynamo" in sys.modules}


def _logits_sha256(logits: torch.Tensor) -> str:
    """The SHA-256 of a tensor's bytes: two forwards whose logits hash the
    same are bit-equal."""
    data = logits.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(data).hexdigest()


def _vs_plain(cfg, params, tokens, logits) -> dict:
    """`logits` (the forward through flash_fwd) against the plain-attention
    forward of the same tokens (no kernel launch): the max abs error and its
    limit (LOGITS_RTOL_OF_MAX x max |plain|), both NLLs."""
    plain = forward(params, tokens, cfg, attention=attention_plain)
    return {"err": (logits - plain).abs().max().item(),
            "limit": LOGITS_RTOL_OF_MAX * plain.abs().max().item(),
            "nll": next_token_nll(logits, tokens).item(),
            "nll_plain": next_token_nll(plain, tokens).item()}


def _check_vs_plain(what: str, p: dict) -> None:
    if not (p["err"] <= p["limit"] and abs(p["nll"] - p["nll_plain"]) <= NLL_ATOL):
        raise RuntimeError(f"{what} vs the plain-attention forward: logits max abs err "
                           f"{p['err']} (limit {p['limit']}), nll {p['nll']} vs "
                           f"{p['nll_plain']} (limit {NLL_ATOL})")


#: the SHA-256 of phase 3's first forward's logits (None until phase 3 ran),
#: and whether each tenant forward held against it since was bit-equal
PHASE3_LOGITS = {"sha256": None, "tenants": []}


def _tenant_forward() -> dict:
    """A tenant's full-width probe forward (phase 3's weights and first
    batch) through flash_fwd on CUDA's device 0: its launches, NLL,
    finiteness and shape, its time (the call until the device is done, host
    clock), the SHA-256 of its logits and its logits against the
    plain-attention forward (``_vs_plain``)."""
    cfg = full_width_config()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (FULL["B"], FULL["L"]))).cuda()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    logits = forward(params, tokens, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _kernel_counts()
    return {"device": torch.cuda.get_device_name(0), "launches": launches, "ms": ms,
            "nll": next_token_nll(logits, tokens).item(),
            "finite": bool(torch.isfinite(logits).all()), "shape": list(logits.shape),
            "sha256": _logits_sha256(logits), "vs_plain": _vs_plain(cfg, params, tokens, logits)}


def _check_tenant_forward(what: str, report: dict) -> None:
    """The tenant's forward held: its launches (n_layers of flash_fwd), its
    shape, NLL and finiteness, its logits against the plain-attention
    forward within LOGITS_RTOL_OF_MAX and NLL_ATOL, as phase 3 holds its
    own, and, once phase 3 ran, bit-equal to phase 3's (the same weights,
    tokens, kernel and card: flash_fwd's forward is deterministic there)."""
    cfg = full_width_config()
    _check_counts(what, report["launches"],
                  {"flash_fwd": cfg.n_layers, "dq": 0, "dkv": 0, "flash_decode": 0})
    nll = report["nll"]
    if not (report["finite"] and report["shape"] == [FULL["B"], FULL["L"], cfg.vocab]
            and 0 <= nll - math.log(cfg.vocab) < NLL_ABOVE_UNIFORM):
        raise RuntimeError(f"{what}'s forward: {report}")
    _check_vs_plain(f"{what}'s forward", report["vs_plain"])
    want = PHASE3_LOGITS["sha256"]
    PHASE3_LOGITS["tenants"].append(report["sha256"] == want)
    if want is not None and report["sha256"] != want:
        raise RuntimeError(f"{what}'s logits are not bit-equal to phase 3's: SHA-256 "
                           f"{report['sha256']} against {want}")


def _v2_child(spec: dict) -> None:
    """The tenant of phase 12's round trip on the kernel: joins the cgroup
    and answers the check's requests (``testing/v2tenant.py``); its
    workload is ``_tenant_forward``, CUDA first touched there."""
    torch.backends.cuda.matmul.allow_tf32 = False
    v2tenant.serve(spec, workload=_tenant_forward)


def _tenant_child(uuid: str) -> dict:
    """Run the tenant child on `uuid`; check its device, launches and NLL.
    Returns its report with exec_to_cuda_ready_ms (from just before the
    spawn to CUDA ready in the child, host clock)."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": uuid}
    t_spawn = time.time()
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--mount-child",
                          json.dumps({"uuid": uuid})], capture_output=True, text=True,
                         timeout=600, env=env)
    if out.returncode != 0:
        raise RuntimeError(f"tenant child exited {out.returncode}:\n{out.stdout[-2000:]}\n"
                           f"{out.stderr[-4000:]}")
    report = next(json.loads(line) for line in out.stdout.splitlines()
                  if line.startswith("{"))["mount_child"]
    _check_tenant_forward("tenant child", report)
    report["exec_to_cuda_ready_ms"] = (report["ready_at"] - t_spawn) * 1e3
    return report


def phase_native(card: str, kernel_build_s: float) -> dict:
    """Phase 10's first part: build the native layer (the namespace helper
    and the /proc scan's library, g++ from the checkout's sources) and
    print its build time beside the kernels'; then time the namespace entry
    with the compiled helper and, for the record, with its plain version
    (``nsexec.py`` in a new interpreter), in turns, MOUNT["REPEATS"] runs
    each, an empty batch into this process's own mount namespace. Returns
    the times."""
    before = native.status()
    t0 = time.perf_counter()
    paths = native.build()
    build_s = time.perf_counter() - t0
    fresh = [kind for kind in native.ARTIFACTS if not before[f"{kind}_built"]]
    print(f"build native layer: {build_s:.2f} s ({native.compiler()} "
          f"{' '.join(native.CXX_FLAGS)}; compiled {fresh or 'nothing, built at an earlier use'}: "
          f"{', '.join(p.name for p in paths.values())}), beside the kernels' build "
          f"{kernel_build_s:.1f} s in phase 1 [{card}]", flush=True)
    ns_path = f"/proc/{os.getpid()}/ns/mnt"

    def plain_entry() -> None:
        code, report, stderr = run_helper(plain_helper_argv(ns_path, []))
        if (code, report) != (0, {"results": []}):
            raise RuntimeError(f"the plain helper: exit {code}, {report}, {stderr[-2000:]}")

    entries = [("compiled", lambda: run_in_mount_ns(os.getpid(), [])), ("plain", plain_entry)]
    times = {"compiled": [], "plain": []}
    for i in range(MOUNT["REPEATS"]):  # in turns, so that a slow spell of the host hits both
        for kind, entry in entries if i % 2 == 0 else entries[::-1]:
            t = time.perf_counter()
            entry()
            times[kind].append((time.perf_counter() - t) * 1e3)
    entry_ms, plain_ms = times["compiled"], times["plain"]
    print(f"time mount namespace entry, in turns with the plain helper (compiled, plain, plain, "
          f"compiled, ...): the compiled helper {paths['nsexec'].name} (exec, setns, exit, "
          f"wait) {_runs(entry_ms)}; the plain helper, for the record (nsutil/nsexec.py in a new "
          f"interpreter) {_runs(plain_ms)} [{card}]", flush=True)
    return {"build_s": build_s, "compiled": fresh, "entry_ms": entry_ms,
            "plain_entry_ms": plain_ms}


def phase_mount(card: str, kernel_build_s: float) -> dict:
    """Phase 10: the native layer's build and namespace entry
    (``phase_native``); the live NvidiaDeviceBackend's inventory against
    nvidia-smi and stat(2); this process among the GPU's holders and the
    GPU healthy; the worker's add_gpu / remove_gpu in process over a
    FakeCluster on the live backend (round trip with CAP_MKNOD, refusal and
    rollback without), into a tmpfs directory that stands for the tenant's
    /dev (a container's /dev is a tmpfs; the checkout's filesystem may
    refuse device nodes) through the mount namespace of this process, with
    the grant on a child of the cgroup-v1 devices hierarchy where one is
    writable; the same flows on a fake host of 8 GPUs. Returns
    ``mount_check``'s report (phase 11 prints its times beside the HTTP
    flows')."""
    t_phase = time.perf_counter()
    native_report = phase_native(card, kernel_build_s)
    identity = pick_identity()
    print(f"mount inventory: identity source {identity} (/proc/driver/nvidia/gpus "
          f"{'lists the GPUs' if identity == 'procfs' else 'absent'}) [{card}]", flush=True)
    inv = inventory_check(identity)
    scan = inv["scan"]
    for dev in scan.devices:
        smi = inv["smi"][dev.index]
        print(f"mount inventory: /dev/{dev.basename} {dev.major}:{dev.minor} -> GPU NVML index "
              f"{dev.index}, {dev.uuid}, PCI {dev.pci_bus_id or '(not given)'}; nvidia-smi: "
              f"{smi['uuid']}, PCI {smi['pci_bus_id']}; numbers equal to stat's", flush=True)
        for comp in dev.companions:
            print(f"mount inventory: companion /dev/{comp.rel_path} {comp.major}:{comp.minor} "
                  f"(stat's)", flush=True)
    for name, major, minor, why in scan.unbound:
        print(f"mount inventory: /dev/{name} {major}:{minor} is not a device: {why}", flush=True)
    for name, why in sorted(scan.absent_companions.items()):
        print(f"mount inventory: companion /dev/{name} left out: {why}", flush=True)
    if len(scan.devices) != 1 or scan.missing:
        raise RuntimeError(f"the live backend lists {len(scan.devices)} GPU(s), GPUs without "
                           f"a node {scan.missing}; one card expected")
    dev = scan.devices[0]
    busy = busy_health_check(NvidiaDeviceBackend("/dev", make_identity(identity)), dev)
    print(f"mount busy and health: holders of {dev.device_path} {busy['holders']} include "
          f"this process ({os.getpid()}); probe_device healthy", flush=True)
    print(f"time mount /proc scan, in turns (native, plain, plain, native, ...): native "
          f"{_runs(busy['scan_runs_ms'])}, plain {_runs(busy['plain_scan_runs_ms'])}, the same "
          f"holders each time, over {busy['pids']} processes [{card}]", flush=True)

    seen = []

    def on_mounted(uuids, target):
        visible = gpus_visible_in_dev(target)
        if visible != 1:
            raise RuntimeError(f"gpus_visible_in_dev({target}) = {visible} with {uuids} mounted")
        seen.append(visible)

    with _tenant_target("phase10") as (dev_dir, cgroup_dir):
        report = mount_check("cuda", dev_dir=dev_dir, ns_pid=os.getpid(),
                             cgroup_dirs=[cgroup_dir] if cgroup_dir else (),
                             identity=identity, fake_gpus=MOUNT["FAKE_GPUS"],
                             repeats=MOUNT["REPEATS"], on_mounted=on_mounted)
    live = report["live"]
    if live["case"] == "round-trip":
        print(f"mount flow: add_gpu(1) mounted {live['uuids']}: /dev/{dev.basename} and "
              f"{len(dev.companions)} companion(s) landed as character devices with the card's "
              f"numbers, gpus_visible_in_dev read {seen[0]}; remove_gpu took the node away and "
              f"released the slave pod; {MOUNT['REPEATS']} round trips", flush=True)
    else:
        print(f"mount flow: add_gpu(1) refused, {live['refusal']!r}; the slave pod deleted and "
              f"the free count back to 1, {MOUNT['REPEATS']} times", flush=True)
    for name, flow in [("live", live)] + [(f"fake {n}-GPU host ({MOUNT['FAKE_GPUS']} GPUs)", f)
                                          for n, f in report["fake"].items()]:
        what = f"add_gpu({flow['n']})" + (" refused" if flow["case"] == "refused" else "")
        line = f"time mount {name} {what}: {_runs(flow['add_ms'])}"
        if flow["remove_ms"]:
            line += f"; remove_gpu: {_runs(flow['remove_ms'])}"
        if flow["add_phases_ms"]:
            line += (f"; last add phases {flow['add_phases_ms']}, remove phases "
                     f"{flow['remove_phases_ms']}")
        print(line + f" [{card}]", flush=True)
    print(f"time mount phase 10: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    report["device"] = dev
    report["native"] = {**native_report, "scan_ms": busy["scan_runs_ms"],
                        "plain_scan_ms": busy["plain_scan_runs_ms"], "pids": busy["pids"]}
    return report


@contextlib.contextmanager
def _tenant_target(tag: str):
    """(dev_dir, cgroup_dir): a tmpfs directory standing for the tenant's
    /dev, and a child of the cgroup-v1 devices hierarchy where one is
    writable (else None); printed, and removed on exit."""
    dev_dir = tempfile.mkdtemp(prefix="tenant-dev-", dir="/dev/shm")
    devices_root = "/sys/fs/cgroup/devices"
    cgroup_dir = None
    if detect_cgroup_version() == 1 and os.access(devices_root, os.W_OK):
        cgroup_dir = os.path.join(devices_root, f"tpumounter-{tag}-{os.getpid()}")
        os.mkdir(cgroup_dir)
    print(f"mount target ({tag}): CapEff {'has' if has_cap_mknod() else 'lacks'} CAP_MKNOD, "
          f"so the {'round trip (inject, then remove)' if has_cap_mknod() else 'refusal and rollback'}"
          f" case runs; {dev_dir} ({_filesystem(dev_dir)}) through the mount namespace of PID "
          f"{os.getpid()}; cgroup "
          f"{cgroup_dir or '(no writable v1 devices hierarchy: a stand-in directory)'}",
          flush=True)
    try:
        yield dev_dir, cgroup_dir
    finally:
        shutil.rmtree(dev_dir, ignore_errors=True)
        if cgroup_dir:
            os.rmdir(cgroup_dir)


#: what torch.distributed and torchrun read from the environment: the slice's
#: tenant child gets these from the plan only
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "NNODES", "NODE_RANK", "NPROC_PER_NODE",
            "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
            "ACCELERATOR_TYPE")


def _slice_child(spec: dict) -> None:
    """The tenant of phase 11's live slice, started with
    CUDA_VISIBLE_DEVICES=<the UUID /addslice mounted> and its worker's env
    from the plan: CUDA's one device must be that GPU; the process group is
    re-formed from the plan (``reinit_distributed`` at MASTER_ADDR and the
    port in `spec`, the default backends: NCCL for CUDA tensors, which it
    must name), one all-reduce of a CUDA tensor must give the sum of every
    rank's rank + 1; then phase 3's first forward through flash_fwd. Prints
    one JSON line; a failure raises (exit code 1)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    env = {k: os.environ[k] for k in DIST_ENV if k in os.environ}
    uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
    torch.cuda.synchronize()
    t_ready = time.time()
    if uuid != spec["uuid"] or torch.cuda.device_count() != 1:
        raise RuntimeError(f"CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r}: "
                           f"{torch.cuda.device_count()} device(s), device 0 is {uuid}, "
                           f"/addslice mounted {spec['uuid']}")
    world, per_node = int(env["WORLD_SIZE"]), int(env["NPROC_PER_NODE"])
    rank = int(env["NODE_RANK"]) * per_node
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    reinit_distributed(f"{env['MASTER_ADDR']}:{spec['port']}", world, rank)
    init_ms = (time.perf_counter() - t0) * 1e3
    reduce_ms = []
    for _ in range(2):  # the first makes NCCL's communicator
        value = torch.full((4,), float(rank + 1), device="cuda")
        t0 = time.perf_counter()
        dist.all_reduce(value)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
        got = value.tolist()
        if got != [world * (world + 1) / 2] * 4:
            raise RuntimeError(f"all_reduce over {world} rank(s): {got}")
    backends = dist.get_backend_config()
    dist.destroy_process_group()
    if "cuda:nccl" not in backends:
        raise RuntimeError(f"the slice's process group runs CUDA tensors on {backends!r}, "
                           f"not NCCL")
    print(json.dumps({"slice_child": {"ready_at": t_ready, "uuid": uuid, "env": env,
                                      "rank": rank,
                                      "backends": backends, "all_reduce": got[0],
                                      "init_ms": init_ms, "all_reduce_ms": reduce_ms,
                                      **_tenant_forward()}}))


def _slice_tenant(plan: dict, uuid: str) -> dict:
    """Run the slice's tenant child on `uuid` with the plan's first worker
    env and no other distributed variable; check its env, device, launches
    and NLL."""
    worker = plan["workers"][0]
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env.update(worker["env"], CUDA_VISIBLE_DEVICES=uuid)
    t_spawn = time.time()
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--slice-child",
                          json.dumps({"uuid": uuid, "port": _free_port()})],
                         capture_output=True, text=True, timeout=600, env=env)
    if out.returncode != 0:
        raise RuntimeError(f"slice tenant child exited {out.returncode}:\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    report = next(json.loads(line) for line in out.stdout.splitlines()
                  if line.startswith("{"))["slice_child"]
    if report["env"] != worker["env"]:
        raise RuntimeError(f"the child read {report['env']}, the plan gave {worker['env']}")
    _check_tenant_forward("slice tenant child", report)
    report["exec_to_cuda_ready_ms"] = (report["ready_at"] - t_spawn) * 1e3
    return report


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_slice(card: str, master_report: dict) -> int:
    """Phase 11's slice and batch routes (``entry.slice_check`` on the card;
    see the module's docstring, 11 d). Returns the slice tenant's flash_fwd
    launches."""
    t_phase = time.perf_counter()
    children = []

    def on_mounted(plan, uuids, target):
        visible = gpus_visible_in_dev(target)
        if visible != 1:
            raise RuntimeError(f"gpus_visible_in_dev({target}) = {visible} after /addslice "
                               f"mounted {uuids}")
        print(f"master slice plan (live, 1 x 1): slice {json.dumps(plan['slice'])}; worker 0 "
              f"env {json.dumps(plan['workers'][0]['env'])}", flush=True)
        children.append(_slice_tenant(plan, uuids[0]))

    with _tenant_target("phase11-slice") as (dev_dir, cgroup_dir):
        report = slice_check("cuda", dev_dir=dev_dir, ns_pid=os.getpid(),
                             cgroup_dirs=[cgroup_dir] if cgroup_dir else (),
                             identity=pick_identity(), repeats=MOUNT["REPEATS"],
                             on_mounted=on_mounted)
    live = report["live"]
    if live["case"] == "round-trip":
        child = children[0]
        print(f"master slice flow: POST /addslice (1 x 1, nvidia-h100-80gb) answered 200 with "
              f"the plan, mounting {live['uuids']}; POST /removeslice answered 200 "
              f"{{'tenant-slice': 'Success'}}, the node gone and the slave pod released; "
              f"{MOUNT['REPEATS']} round trips", flush=True)
        print(f"master slice tenant: CUDA_VISIBLE_DEVICES={child['uuid']} (the UUID /addslice "
              f"mounted), exec -> CUDA ready {child['exec_to_cuda_ready_ms']:.1f} ms, env "
              f"{child['env']} from the plan; reinit_distributed("
              f"{child['env']['MASTER_ADDR']}:<port>, {child['env']['WORLD_SIZE']}, "
              f"{child['rank']}) with backends {child['backends']} in {child['init_ms']:.1f} "
              f"ms; all_reduce of a CUDA tensor = {child['all_reduce']} (expected 1.0), the "
              f"first (NCCL's communicator made) {child['all_reduce_ms'][0]:.3f} ms, the second "
              f"{child['all_reduce_ms'][1]:.3f} ms; full-width forward through flash_fwd, "
              f"launches {child['launches']}, nll {child['nll']:.4f} (log V "
              f"{math.log(full_width_config().vocab):.4f}) [{card}]", flush=True)
    else:
        print(f"master slice flow: /addslice refused, {live['refusal']!r}; rolled back, "
              f"{MOUNT['REPEATS']} times", flush=True)
    http_live = master_report["live"]
    print(f"time master slice live 1 x 1 HTTP /addslice: {_runs(live['add_ms'])}"
          + (f"; /removeslice: {_runs(live['remove_ms'])}" if live["remove_ms"] else "")
          + f"; phase 11's /addgpu .../gpu/1: {_runs(http_live['add_ms'])}"
          + (f", /removegpu: {_runs(http_live['remove_ms'])}" if http_live["remove_ms"] else "")
          + f" [{card}]", flush=True)
    fleet, fake8 = report["fleet"], master_report["fake"][MOUNT["FAKE_GPUS"]]
    print(f"time master slice fleet {fleet['hosts']} x {fleet['gpus']} (fake hosts, one worker "
          f"gRPC server each, in this process) HTTP /addslice: {_runs(fleet['add_ms'])}; "
          f"/removeslice: {_runs(fleet['remove_ms'])}; phase 11's fake 8-GPU host /addgpu "
          f".../gpu/8: {_runs(fake8['add_ms'])}, /removegpu: {_runs(fake8['remove_ms'])} "
          f"[{card}]", flush=True)
    rollback, batch = report["rollback"], report["batch"]
    print(f"time master slice rolled back (4 x 1, one host squatted; {rollback['status']} "
          f"{rollback['body']!r}, every other host free again): {_runs(rollback['ms'])} "
          f"[{card}]", flush=True)
    print(f"time master batch /batch/addgpu ({batch['targets']} targets on 4 nodes, byResult "
          f"{batch['by_result']}, the books exact): {_runs(batch['ms'])} [{card}]", flush=True)
    print(f"master fan-out tasks by kind (tpumounter_fanout_tasks_total during slice_check): "
          f"{report['fanout_tasks']}", flush=True)
    print(f"time master slice part of phase 11: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return sum(c["launches"]["flash_fwd"] for c in children)


def phase_master(card: str, mount_report: dict, handoff_ready_ms: dict) -> int:
    """Phase 11: the hot-mount through the master. ``entry.master_check`` on
    the card: GET /addgpu/.../gpu/1/isEntireMount/false to the port's
    MasterApp on 127.0.0.1, routed to the node's GpuMountService over the
    worker's gRPC server, into the same kind of target as phase 10; a tenant child on the UUID that request mounted (CUDA's device 0
    that UUID, phase 3's first forward through flash_fwd); POST
    /removegpu/.../force/false; the error mapping on the live host (gpu/2
    on one card 500 Insufficient, an unknown pod 404, an unknown UUID 400,
    no token 401); the same flows on a fake host of 8 GPUs. The HTTP add and
    remove times are printed beside phase 10's in-process ones. Then the slice
    and batch routes (``phase_slice``). Returns the flash_fwd launches of
    both tenant children, and the live flow's report (its add and remove
    times, for phase 13)."""
    t_phase = time.perf_counter()
    dev = mount_report["device"]
    children = []

    def on_mounted(uuids, target):
        visible = gpus_visible_in_dev(target)
        if visible != 1:
            raise RuntimeError(f"gpus_visible_in_dev({target}) = {visible} after the HTTP add "
                               f"of {uuids}")
        children.append({**_tenant_child(uuids[0]), "visible_in_dev": visible})

    with _tenant_target("phase11") as (dev_dir, cgroup_dir):
        report = master_check("cuda", dev_dir=dev_dir, ns_pid=os.getpid(),
                              cgroup_dirs=[cgroup_dir] if cgroup_dir else (),
                              identity=pick_identity(), fake_gpus=MOUNT["FAKE_GPUS"],
                              repeats=MOUNT["REPEATS"], on_mounted=on_mounted)
    print(f"master transport: gRPC (the worker's server and the kubelet's socket); the "
          f"master's HTTP server on 127.0.0.1 answered every request [{card}]", flush=True)
    live = report["live"]
    if live["case"] == "round-trip":
        print(f"master flow: GET /addgpu/namespace/default/pod/tenant-http-1/gpu/1/"
              f"isEntireMount/false answered 200 'Add GPU Success', mounting {live['uuids']} "
              f"(gpus_visible_in_dev read {children[0]['visible_in_dev']}); POST "
              f"/removegpu/.../force/false with that UUID answered 200, the node gone and the "
              f"slave pod released; {MOUNT['REPEATS']} round trips", flush=True)
    else:
        print(f"master flow: the HTTP add refused, {live['refusal']!r}; rolled back, "
              f"{MOUNT['REPEATS']} times", flush=True)
        children.append({**_tenant_child(dev.uuid), "visible_in_dev": None})
    print("master errors on the live host: " + "; ".join(
        f"{case} {status} {body!r}" for case, (status, body) in report["live_errors"].items()),
        flush=True)
    child = children[0]
    print(f"mount tenant: CUDA_VISIBLE_DEVICES={child['uuid']} (the UUID the HTTP add mounted) "
          f"gives device 0 {child['device']} of that UUID; full-width forward through "
          f"flash_fwd, launches {child['launches']}, nll {child['nll']:.4f} (log V "
          f"{math.log(full_width_config().vocab):.4f})", flush=True)
    imports = child["imports"]
    print(f"time mount tenant exec -> CUDA ready: {child['exec_to_cuda_ready_ms']:.1f} ms "
          f"(spawn of python3 chip_smoke.py --mount-child to torch.cuda.init() done; "
          f"{imports['modules']} modules loaded, {imports['port']} of the port, torch._dynamo "
          f"{'among them' if imports['dynamo'] else 'not'}); phase 6's "
          f"new image exec -> CUDA ready, median: "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in handoff_ready_ms.items()) + f" [{card}]",
          flush=True)
    in_process = mount_report["live"]
    what = "refused" if live["case"] == "refused" else "round trip"
    print(f"time master live HTTP add (GET /addgpu .../gpu/1, {what}): {_runs(live['add_ms'])}"
          + (f"; HTTP remove: {_runs(live['remove_ms'])}" if live["remove_ms"] else "")
          + f"; phase 10's in-process add_gpu(1): {_runs(in_process['add_ms'])}"
          + (f", remove_gpu: {_runs(in_process['remove_ms'])}" if in_process["remove_ms"]
             else "") + f" [{card}]", flush=True)
    for n, flow in report["fake"].items():
        base = mount_report["fake"][n]
        print(f"time master fake {n}-GPU host ({MOUNT['FAKE_GPUS']} GPUs) HTTP add: "
              f"{_runs(flow['add_ms'])}; HTTP remove: {_runs(flow['remove_ms'])}; phase 10's "
              f"in process: add_gpu({n}) {_runs(base['add_ms'])}, remove_gpu "
              f"{_runs(base['remove_ms'])} [{card}]", flush=True)
    print(f"time master worker call alone (AddGPU of a missing pod over gRPC): "
          f"live {_runs(report['call_ms']['live'])}, fake host {_runs(report['call_ms']['fake'])}"
          f"; the wire codec, one AddGPU and one RemoveGPU exchange encoded and decoded: "
          f"{report['codec_ms'] * 1e3:.1f} us [{card}]", flush=True)
    slice_launches = phase_slice(card, report)
    print(f"time master phase 11: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return sum(c["launches"]["flash_fwd"] for c in children) + slice_launches, live


def phase_cgroup_v2(card: str) -> int:
    """Phase 12: ``entry.cgroup_v2_check`` on the card's GPU (see the
    module's docstring); returns the flash_fwd launches of the kernel round
    trip's tenant (0 where the kernel refused the probe)."""
    t_phase = time.perf_counter()
    report = cgroup_v2_check("cuda", identity=pick_identity(),
                             tenant_argv=[sys.executable, os.path.abspath(__file__), "--v2-child"])
    gpu = report["gpu"]
    print(f"cgroup v2 inventory: /dev/{gpu.basename} {gpu.major}:{gpu.minor}, companions "
          + ", ".join(f"/dev/{c.rel_path} {c.major}:{c.minor}" for c in gpu.companions)
          + " (stat's)", flush=True)
    asm = report["assembly_us"]
    print(f"time cgroup v2 program assembly: static rules (defaults + the GPU's group) "
          f"{asm['static_insns']} insns in {asm['static']:.1f} us; map path (defaults, telemetry "
          f"and policy blocks) {asm['maps_insns']} insns in {asm['maps']:.1f} us [{card}]",
          flush=True)
    for path, flow in report["stub"].items():
        print(f"cgroup v2 stubbed kernel, {path} path: after grant_many rw admitted on "
              f"/dev/{gpu.basename} and its {len(gpu.companions)} companion(s) "
              f"{flow['granted']}, neighbouring minor denied ({flow['neighbour']}); after the "
              f"last revoke runc's program alone, all denied {flow['revoked']}", flush=True)
        print(f"time cgroup v2 stubbed kernel, {path} path: grant {flow['grant_ms']:.3f} ms, "
              f"revoke {flow['revoke_ms']:.3f} ms [{card}]", flush=True)
    print("cgroup v2 kernel probe: " + ", ".join(f"{k} {v}" for k, v in report["probe"].items()),
          flush=True)
    flow = report["kernel"]
    if flow is None:
        refused = {k: v for k, v in report["probe"].items() if v != "ok"}
        print(f"cgroup v2 branch: probe refused ({refused}); the round trip on the kernel is "
              f"not run here", flush=True)
        launches = 0
    else:
        _check_tenant_forward("phase 12's tenant", flow["run"])
        launches = flow["run"]["launches"]["flash_fwd"]
        print(f"cgroup v2 branch: kernel round trip: runc's program ids {flow['ids_before']}; "
              f"the tenant's opens before the grant {flow['before']}, after {flow['granted']}, "
              f"after the revoke {flow['after']}; ours {flow['ids_granted']}; a restarted "
              f"controller restored {flow['restored']}; ids after the revoke "
              f"{flow['ids_after']}; the tenant's forward: flash_fwd {launches}, nll "
              f"{flow['run']['nll']:.4f}", flush=True)
        print(f"time cgroup v2 kernel: grant {flow['grant_ms']:.3f} ms, revoke "
              f"{flow['revoke_ms']:.3f} ms, the tenant's forward {flow['run_ms']:.1f} ms "
              f"[{card}]", flush=True)
    print(f"time cgroup v2 phase 12: {time.perf_counter() - t_phase:.3f} s [{card}]", flush=True)
    return launches


# --- phase 13: tracing, audit and failpoints on a live hot-mount ---

#: phase 11's HTTP add and remove of the live GPU in the runs before
#: any span existed (PERF.md section 5; ms, host clock, median of 3 a call)
UNTRACED_ADD_MS = (64.9, 111.8)
UNTRACED_REMOVE_MS = (63.7, 159.4)
#: the audited records of one add: the master's edge record and the worker's
ADD_AUDIT_RECORDS = 2


def phase_obs(card: str, master_live: dict) -> None:
    """Phase 13: ``entry.obs_check`` on the card. No kernel runs. (a) 3
    traced round trips of the live GPU through the master over gRPC: each
    request's trace id, /trace/<id>'s spans and parents (``ADD_TRACE``,
    ``REMOVE_TRACE``), no open span, the edge's and the worker's audit
    records under the id, /timeline, the Events; each span's ms, the
    worker's spans' share of worker.AddGPU, the traced add and remove
    beside phase 11's (this call's, and the range before spans). (b) the
    faults, each ending with the GPU addable again: worker.mount.after_grant
    (500, rolled back), rpc.client.call (200 after one retry),
    master.slice.mount on a live slice of 1 (500, nothing changed); an add
    of 2 under worker.mount.mknod=1*pass->1*error on the fake 8-GPU host.
    (c) the instrumentation's costs on this host."""
    t_phase = time.perf_counter()
    with _tenant_target("phase13") as (dev_dir, cgroup_dir):
        report = obs_check("cuda", dev_dir=dev_dir, ns_pid=os.getpid(),
                           cgroup_dirs=[cgroup_dir] if cgroup_dir else (),
                           identity=pick_identity(), fake_gpus=MOUNT["FAKE_GPUS"],
                           repeats=MOUNT["REPEATS"])
    flows = report["live"] or report["fake"]
    where = ("the live GPU" if report["live"] else
             f"the fake host of {MOUNT['FAKE_GPUS']} (no CAP_MKNOD: the live add is refused)")
    rt = flows["round_trip"]
    add_tid, rm_tid = rt["trace_ids"][0]
    spans = " ".join(f"{n} <- {p or 'root'}" for n, p in ADD_TRACE.items())
    print(f"obs traced round trip on {where}, {MOUNT['REPEATS']} times: each response carried "
          f"its own X-Tpumounter-Trace (first add {add_tid}, remove {rm_tid}); /trace/<id> held "
          f"{spans}, every span ok, "
          f"and the remove's {len(REMOVE_TRACE)} spans likewise; no span open after; /audit under "
          f"each id: the edge's record 'http 200' and the worker's 'Success'; /timeline under "
          f"each id: the root span, both records and the Event; Events on the pod "
          f"{rt['events']} [{card}]", flush=True)
    for name in ADD_TRACE:
        print(f"time obs span {name} (traced add of 1 GPU): {_runs(rt['span_ms'][name])} "
              f"[{card}]", flush=True)
    shares = [100 * s for s in rt["worker_share"]]
    print(f"time obs the worker's spans ({', '.join(ADD_WORKER_SPANS)}) as a share of "
          f"worker.AddGPU: {statistics.median(shares):.1f}% (runs "
          f"{', '.join(f'{s:.1f}%' for s in shares)}) [{card}]", flush=True)
    print(f"time obs traced HTTP add (GET /addgpu .../gpu/1): {_runs(rt['add_ms'])}; traced "
          f"HTTP remove: {_runs(rt['remove_ms'])}; this call's phase 11 (traced too): add "
          f"{_runs(master_live['add_ms'])}, remove {_runs(master_live['remove_ms'])}; phase "
          f"11 before any span existed: add {UNTRACED_ADD_MS[0]}-{UNTRACED_ADD_MS[1]} ms, "
          f"remove {UNTRACED_REMOVE_MS[0]}-{UNTRACED_REMOVE_MS[1]} ms [{card}]", flush=True)
    ag, dc, sa = flows["after_grant"], flows["dropped_call"], flows["slice_admission"]
    print(f"obs faults on {where}: worker.mount.after_grant=1*error -> {ag['status']} in "
          f"{ag['ms']:.3f} ms, mount.rollback {ag['rollback_ms']:.3f} ms with no revoke "
          f"failed (the v1 revoke: {'; '.join(ag['revoke']) or 'no cgroup'}), no node left, "
          f"the slave pod released, audit {ag['outcomes']}; rpc.client.call=1*unavailable -> "
          f"{dc['status']} in "
          f"{dc['ms']:.3f} ms after {dc['retries']} retry under idempotency key "
          f"{dc['idempotency_key']}, worker.AddGPU once; master.slice.mount=1*error on a slice "
          f"of 1 -> {sa['status']} in {sa['ms']:.3f} ms, nothing changed; then a round trip "
          f"again: add {_runs(flows['again']['add_ms'])}, remove "
          f"{_runs(flows['again']['remove_ms'])} [{card}]", flush=True)
    two = report["two_gpu_mknod"]
    print(f"obs fault on the fake host of {MOUNT['FAKE_GPUS']}: an add of 2 under "
          f"worker.mount.mknod=1*pass->1*error -> {two['status']} in {two['ms']:.3f} ms, the "
          f"mknod span failed, the rollback ran, neither GPU mounted nor booked [{card}]",
          flush=True)
    costs = report["costs"]
    # an estimate from the means above, not a measured difference: no
    # untraced add runs in this process
    est_ms = (len(ADD_TRACE) * costs["span_us"] + ADD_AUDIT_RECORDS * costs["audit_us"]) / 1e3
    add_ms = statistics.median(rt["add_ms"])
    print(f"time obs costs on the card's host: fire() with nothing armed "
          f"{costs['fire_ns']:.1f} ns (mean of {OBS_COST_ITERS['FIRE']}), one empty span into "
          f"a ring {costs['span_us']:.2f} us (mean of {OBS_COST_ITERS['SPAN']}), one audited "
          f"record {costs['audit_us']:.2f} us (mean of {OBS_COST_ITERS['AUDIT']}); estimated "
          f"from these, not measured: the {len(ADD_TRACE)} spans and {ADD_AUDIT_RECORDS} "
          f"audited records of one add ~{est_ms:.3f} ms, {100 * est_ms / add_ms:.3f}% of its "
          f"median {add_ms:.3f} ms (the flight recorder's records, the wire context and the "
          f"Event post not counted) [{card}]", flush=True)
    print(f"time obs phase 13: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)


# --- phase 14: the worker's durability on a live hot-mount ---

def phase_durability(card: str) -> int:
    """Phase 14: ``entry.durability_check`` on the card (see the module's
    docstring), every case printed on a line of its own. Returns the
    flash_fwd launches of the tenant child on the replayed GPU."""
    t_phase = time.perf_counter()
    children = []

    def on_replayed(uuids, target):
        visible = gpus_visible_in_dev(target)
        if visible != 1:
            raise RuntimeError(f"gpus_visible_in_dev({target}) = {visible} after the replay "
                               f"of {uuids}")
        children.append({**_tenant_child(uuids[0]), "visible_in_dev": visible})

    ledger_root = os.path.dirname(os.path.abspath(__file__))
    with _tenant_target("phase14") as (dev_dir, cgroup_dir):
        report = durability_check("cuda", dev_dir=dev_dir, ns_pid=os.getpid(),
                                  cgroup_dirs=[cgroup_dir] if cgroup_dir else (),
                                  identity=pick_identity(), fake_gpus=MOUNT["FAKE_GPUS"],
                                  repeats=MOUNT["REPEATS"], ledger_root=ledger_root,
                                  on_replayed=on_replayed)
    flows, where = report["live"], "the live GPU"
    if flows is None or len(children) != 1:
        raise RuntimeError(f"phase 14 ran no live replay with its tenant child on the card: "
                           f"live {flows is not None}, {len(children)} child(ren)")
    child = children[0]
    cost = flows["cost"]
    fsync_ms = statistics.median(cost["fsync_us"]) / 1e3
    add_with, add_without = (statistics.median(cost[c]["add_ms"]) for c in ("with", "without"))
    appends = statistics.median(cost["appends_add"])
    print(f"time durability ledger cost on {where}, ledger in {ledger_root} "
          f"({_filesystem(ledger_root)}): HTTP add with the ledger "
          f"{_runs(cost['with']['add_ms'])}, without {_runs(cost['without']['add_ms'])}; "
          f"remove with {_runs(cost['with']['remove_ms'])}, without "
          f"{_runs(cost['without']['remove_ms'])}; appends an add {cost['appends_add']}, a "
          f"remove {cost['appends_remove']}; one append's fsync {fsync_ms * 1e3:.1f} us "
          f"(median of {len(cost['fsync_us'])}, runs {min(cost['fsync_us']):.1f}-"
          f"{max(cost['fsync_us']):.1f}); the ledger's share of an add: from the fsyncs "
          f"{100 * appends * fsync_ms / add_with:.2f}%, from the medians' difference "
          f"{100 * (add_with - add_without) / add_with:.2f}% [{card}]", flush=True)
    fwd = flows["forward"]
    print(f"durability crash after the grant on {where}: the add answered "
          f"{fwd['crash_status']} in {fwd['crash_ms']:.3f} ms with 1 txn open; a new "
          f"GpuMountService over the same ledger, replay_once() {fwd['replay_ms']:.3f} ms: "
          f"open {fwd['summary']['open']}, replayed-completed "
          f"{len(fwd['summary']['completed'])}; {fwd['uuids']} in the target's /dev "
          f"(gpus_visible_in_dev {child['visible_in_dev']}); books == mounts == ledger; the "
          f"tenant child on {child['uuid']} ({child['device']}): flash_fwd "
          f"{child['launches']['flash_fwd']} launch(es), nll {child['nll']:.4f} [{card}]",
          flush=True)
    rb = report["rolled_back"]
    print(f"durability crash before the grant on the fake host of {MOUNT['FAKE_GPUS']}: add "
          f"of 2 answered 500 in {rb['crash_ms']:.3f} ms; {rb['slaves_deleted']} slave pod(s) "
          f"deleted while the worker was down; replay_once() {rb['replay_ms']:.3f} ms: open "
          f"{rb['summary']['open']}, replayed-rolled-back {len(rb['summary']['rolled_back'])}; "
          f"no node, no booking, no open txn [{card}]", flush=True)
    dr = flows["drain"]
    print(f"durability drain on {where}: drain() called while the add was inside "
          f"mount.mknod returned clean in {dr['drain_ms']:.3f} ms; the add answered 200 in "
          f"{dr['add_ms']:.3f} ms; the next add: {dr['refused']!r}; the reopened ledger reads "
          f"a clean shutdown and no open txn [{card}]", flush=True)
    fe = flows["fence"]
    print(f"durability fencing on {where} over gRPC: add with epoch 5 in {fe['add_ms']:.3f} "
          f"ms; remove with epoch 3 refused in {fe['fenced_ms']:.3f} ms ({fe['refusal']!r}), "
          f"tpumounter_fenced_writes_total + 1, nothing changed; the stale master answered "
          f"{fe['master'][0]} with Retry-After 1; after a restart the ledger reads epoch "
          f"{fe['epoch_after_restart']} [{card}]", flush=True)
    df = report["deferred"]
    print(f"durability deferred release on the fake host: the remove while deletes answer "
          f"503 took {df['remove_ms']:.3f} ms (3 attempts), answered 200, "
          f"tpumounter_slave_release_deferred_total + {df['deferred']:.0f}, 1 entry pending; "
          f"healed, retry_pending_releases() emptied it in {df['retry_ms']:.3f} ms; the "
          f"owner pod deleted, reap_once() deleted {df['reaped']} in {df['reap_ms']:.3f} ms "
          f"and the GPU is free [{card}]", flush=True)
    print(f"time durability phase 14: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return child["launches"]["flash_fwd"]


# --- phase 15: the master's store through an API outage on a live hot-mount ---

def phase_degraded(card: str, master_live: dict) -> int:
    """Phase 15: ``entry.degraded_check`` on the card (see the module's
    docstring), a line for each case. Returns the flash_fwd launches of the
    tenant child on the GPU added after the read partition's heal."""
    t_phase = time.perf_counter()
    children = []

    def on_healed(uuids, target):
        visible = gpus_visible_in_dev(target)
        if visible != 1:
            raise RuntimeError(f"gpus_visible_in_dev({target}) = {visible} after the healed "
                               f"add of {uuids}")
        children.append({**_tenant_child(uuids[0]), "visible_in_dev": visible})

    queue_root = os.path.dirname(os.path.abspath(__file__))
    with _tenant_target("phase15") as (dev_dir, cgroup_dir):
        report = degraded_check("cuda", dev_dir=dev_dir, ns_pid=os.getpid(),
                                cgroup_dirs=[cgroup_dir] if cgroup_dir else (),
                                identity=pick_identity(), repeats=MOUNT["REPEATS"],
                                queue_root=queue_root, on_healed=on_healed)
    flows = report["live"]
    if flows is None or len(children) != 1:
        raise RuntimeError(f"phase 15 ran no live flows with their tenant child on the card: "
                           f"live {flows is not None}, {len(children)} child(ren)")
    child = children[0]
    med = statistics.median
    print(f"degraded ApiHealth for the check: {report['health']}; the queue and the ledger in "
          f"{queue_root} ({_filesystem(queue_root)}) [{card}]", flush=True)
    ok = flows["healthy"]
    print(f"time degraded (a) healthy through the store on the live GPU: HTTP add "
          f"{_runs(ok['add_ms'])} against phase 11's {_runs(master_live['add_ms'])}; remove "
          f"{_runs(ok['remove_ms'])} against {_runs(master_live['remove_ms'])}; "
          f"/healthz {ok['healthz'].strip()!r}; /apihealth {ok['apihealth']['api']['state']}, "
          f"cache ages {ok['apihealth']['store']['cacheAgesS']}, queue pending "
          f"{ok['apihealth']['store']['writeBehind']['pending']}; {ok['registry_lists']} "
          f"registry LIST(s) through the store [{card}]", flush=True)
    w = flows["writes"]
    print(f"time degraded (b) write partition around a live remove: the write plane down "
          f"after {w['down_ms']:.3f} ms of failing writes; /healthz {w['healthz']!r}; "
          f"{w['deferred']:.0f} stamps deferred (3 and a CAS seq 1), {w['on_disk']} on disk; "
          f"the remove answered 200 in {w['remove_ms']:.3f} ms, the GPU's node gone, its slave "
          f"release deferred into the ledger; the next release's probe tried "
          f"{w['release_attempts'][0]} record of {w['probe']['pending']}; the add refused "
          f"{w['refused'][0]} in {w['refused_ms']:.3f} ms, nothing mounted, no new slave pod; "
          f"healed (a newer writer's seq 5 first) to healthy in {w['heal_ms']:.3f} ms; the "
          f"flush {w['flush']} in {w['flush_ms']:.3f} ms; reopened queue pending "
          f"{w['reopened_pending']}; releases retried {w['retried']}; books == mounts == "
          f"ledger [{card}]", flush=True)
    t = flows["migration_traffic"]
    print(f"time degraded (b') the elastic and migration routes' writes in a second write "
          f"partition, landing while POST /migrate's machine ({t['id']}, begun in "
          f"{t['begin_ms']:.3f} ms) waits in the quiesce: PUT /intents refused "
          f"{t['put_refused'][0]} in {t['put_ms']:.3f} ms (a user's CRUD is never deferred); "
          f"the quiesce's journal persist and the pause's (paused_for_api at "
          f"{t['paused_phase']}) deferred ({t['deferred']:.0f}) in "
          f"{', '.join(f'{ms:.3f}' for ms in t['persist_ms'])} ms (their spans), the GPU "
          f"still on the source; healed in {t['heal_ms']:.3f} ms, the flush applied "
          f"{t['applied']:.0f} write(s) {t['flush_ms']:.3f} ms after the transition, beside (b)'s "
          f"flush {w['flush_ms']:.3f} ms; the machine then {t['outcome']} (phases "
          f"{t['phases_s']} s), the GPU on the destination, books == mounts == ledger "
          f"[{card}]", flush=True)
    r = flows["reads"]
    print(f"time degraded (c) read partition around a live add: the registry answered from "
          f"its cache; the store's worker LIST served stale (tpumounter_store_stale_reads_total"
          f" + {r['stale_reads']:.0f}, age {r['cache_age_s']} s on /apihealth); the add refused "
          f"{r['refused'][0]} at the pod read in {r['refused_ms']:.3f} ms with "
          f"{r['worker_calls']} worker call(s); a stamp landed directly ({r['queued']} queued); "
          f"healed in {r['heal_ms']:.3f} ms; the add mounted {r['uuids']} in {r['add_ms']:.3f} "
          f"ms (gpus_visible_in_dev {child['visible_in_dev']}); the tenant child on "
          f"{child['uuid']} ({child['device']}): flash_fwd {child['launches']['flash_fwd']} "
          f"launch(es), nll {child['nll']:.4f}, exec to CUDA ready "
          f"{child['exec_to_cuda_ready_ms']:.1f} ms; the remove {r['remove_ms']:.3f} ms "
          f"[{card}]", flush=True)
    c = report["costs"]
    print(f"time degraded (d) costs on the card's host, medians of {len(c['enqueue_us'])}: a "
          f"get_pod on the raw fake {med(c['raw_call_us']):.1f} us, tracked "
          f"{med(c['tracked_call_us']):.1f} us (overhead "
          f"{med(c['tracked_call_us']) - med(c['raw_call_us']):.1f} us); a worker LIST through "
          f"the cache {med(c['cached_read_us']):.1f} us, through the store it wraps "
          f"{med(c['inner_read_us']):.1f} us; one enqueue with its fsync "
          f"{med(c['enqueue_us']):.1f} us (runs {min(c['enqueue_us']):.1f}-"
          f"{max(c['enqueue_us']):.1f}) [{card}]", flush=True)
    print(f"time degraded phase 15: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return child["launches"]["flash_fwd"]


def phase_shard_pool(card: str, master_live: dict) -> int:
    """Phase 16: ``entry.shard_pool_check`` on the card (see the module's
    docstring), a line for each case. Returns the flash_fwd launches of the
    tenant child on the first pooled GPU."""
    t_phase = time.perf_counter()
    children = []

    def on_pooled(uuids, target):
        visible = gpus_visible_in_dev(target)
        if visible != 1:
            raise RuntimeError(f"gpus_visible_in_dev({target}) = {visible} after the pooled "
                               f"add of {uuids}")
        children.append({**_tenant_child(uuids[0]), "visible_in_dev": visible})

    ledger_root = os.path.dirname(os.path.abspath(__file__))
    with _tenant_target("phase16") as (dev_dir, cgroup_dir):
        report = shard_pool_check("cuda", dev_dir=dev_dir, ns_pid=os.getpid(),
                                  cgroup_dirs=[cgroup_dir] if cgroup_dir else (),
                                  identity=pick_identity(), repeats=MOUNT["REPEATS"],
                                  ledger_root=ledger_root, on_pooled=on_pooled)
    flows = report["live"]
    if flows is None or len(children) != 1:
        raise RuntimeError(f"phase 16 ran no live flows with their tenant child on the card: "
                           f"live {flows is not None}, {len(children)} child(ren)")
    child = children[0]
    p = flows["pool"]
    warm, cold = p["warm"], p["cold"]
    starts = ", ".join(f"{k} {v:.1f} ms" for k, v in flows["start_ms"].items())
    print(f"time shard-pool stacks started (workers, replicas, first leases): {starts} "
          f"[{card}]", flush=True)
    print(f"time shard-pool (a) two replicas on their renew loops (lease {p['lease_s']:.0f} s, "
          f"renew {p['renew_s']:.0f} s), the node's owner stamping epoch {p['epoch']}, in the "
          f"worker's ledger ({p['ledger_epoch']}) and still held after the flow's "
          f"{p['flow_s']:.1f} s; ensure_node {p['ensure_node_ms']:.3f} ms; the warm pool of 1 "
          f"filled in {p['first_fill_ms']:.3f} ms; the tenant child {p['child_ms']:.1f} ms; "
          f"{p['refill_failures']:.0f} refill(s) refused on the full node; "
          f"warm (pooled) HTTP add {_runs([r['add_ms'] for r in warm])}"
          f", its slave_pod_schedule span {_runs([r['schedule_ms'] for r in warm])}, remove "
          f"{_runs([r['remove_ms'] for r in warm])}, the refill restoring the pool "
          f"{_runs(p['refill_ms'])}; drained ({p['drained']} holder released), cold HTTP add "
          f"{_runs([r['add_ms'] for r in cold])}, its slave_pod_schedule span "
          f"{_runs([r['schedule_ms'] for r in cold])}, remove "
          f"{_runs([r['remove_ms'] for r in cold])}; phase 11's add "
          f"{_runs(master_live['add_ms'])}; each warm add a hit and no miss, each cold add a "
          f"miss; the tenant child on "
          f"the pooled {child['uuid']} ({child['device']}): flash_fwd "
          f"{child['launches']['flash_fwd']} launch(es), nll {child['nll']:.4f}, exec to CUDA "
          f"ready {child['exec_to_cuda_ready_ms']:.1f} ms (the fake scheduler places a pod in a "
          f"few ms: no real scheduler's wait to save) [{card}]", flush=True)
    r = flows["replicas"]
    print(f"time shard-pool (b) two replicas, shard_count 2, the node's owner replica "
          f"{r['owner']} (epochs {r['epochs']}): /addgpu at the non-owner 307 to "
          f"{r['redirect']}, followed and mounted in {r['followed_ms']:.3f} ms; /batch/addgpu "
          f"at the non-owner proxied once {_runs(r['proxied_ms'])} against a direct batch "
          f"{_runs(r['direct_ms'])}; a forwarded batch at the non-owner {r['forwarded']} "
          f"[{card}]", flush=True)
    c = flows["stale"]
    print(f"time shard-pool (c) a stale owner: its lease writes partitioned, the takeover at "
          f"epoch {c['fresh_epoch']} (was {c['stale_epoch']}) in {c['takeover_ms']:.3f} ms; the "
          f"new owner's add {c['new_add_ms']:.3f} ms; the stale add fenced by the worker in "
          f"{c['fenced_ms']:.3f} ms: 503 {c['fenced']!r}, nothing mounted, booked or in the "
          f"ledger (epoch {c['ledger_epoch']}); the new owner's remove {c['remove_ms']:.3f} ms, "
          f"the GPU free [{card}]", flush=True)
    print(f"time shard-pool phase 16: {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return child["launches"]["flash_fwd"]


#: the fleet phase's tenant: full-width forwards, each a TenantTelemetry step
FLEET = dict(STEPS=4)
#: the environment variable that hands the fleet child the mutate token
TENANT_TOKEN_ENV = "TPUMOUNTER_TENANT_TOKEN"


def _fleet_child(spec: dict) -> None:
    """The tenant of phase 17, started with CUDA_VISIBLE_DEVICES=<the UUID
    the worker assigned>: CUDA's one device must be that GPU; then
    spec["steps"] full-width forwards (phase 3's weights and first batch)
    through flash_fwd, each a ``TenantTelemetry`` step, and the snapshot
    POSTed to the worker's ops port with the mutate token from the
    environment. Prints one JSON line; a failure raises (exit code 1)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.init()
    props = torch.cuda.get_device_properties(0)
    torch.cuda.synchronize()
    t_ready = time.time()
    uuid = f"GPU-{props.uuid}"
    if uuid != spec["uuid"] or torch.cuda.device_count() != 1:
        raise RuntimeError(f"CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r}: "
                           f"{torch.cuda.device_count()} device(s), device 0 is {uuid}, the "
                           f"worker assigned {spec['uuid']}")
    cfg = full_width_config()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (FULL["B"], FULL["L"]))).cuda()
    tel = TenantTelemetry(spec["tenant"], namespace=spec["namespace"], pod=spec["pod"],
                          token=os.environ[TENANT_TOKEN_ENV])
    _reset_kernel_counts()
    step_ms = []
    for _ in range(spec["steps"]):
        t0 = time.perf_counter()
        with tel.step(tokens=float(tokens.numel())):
            logits = forward(params, tokens, cfg)
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _kernel_counts()
    t0 = time.perf_counter()
    published = tel.publish(spec["url"])
    print(json.dumps({"fleet_child": {
        "ready_at": t_ready, "uuid": uuid, "device": torch.cuda.get_device_name(0),
        "launches": launches, "nll": next_token_nll(logits, tokens).item(),
        "finite": bool(torch.isfinite(logits).all()), "shape": list(logits.shape),
        "tenant": spec["tenant"], "steps": spec["steps"], "step_ms": step_ms,
        "published": published, "publish_ms": (time.perf_counter() - t0) * 1e3}}))


def _fleet_tenant(uuid: str, url: str, token: str) -> dict:
    """Run the fleet child on `uuid`, publishing to `url`; check its device,
    launches (FLEET["STEPS"] forwards), NLL and publish. Returns its report
    with exec_to_cuda_ready_ms."""
    spec = {"uuid": uuid, "url": url, "tenant": "default/tenant-fleet",
            "namespace": "default", "pod": "tenant-fleet", "steps": FLEET["STEPS"]}
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": uuid, TENANT_TOKEN_ENV: token}
    t_spawn = time.time()
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--fleet-child",
                          json.dumps(spec)], capture_output=True, text=True, timeout=600,
                         env=env)
    if out.returncode != 0:
        raise RuntimeError(f"fleet child exited {out.returncode}:\n{out.stdout[-2000:]}\n"
                           f"{out.stderr[-4000:]}")
    report = next(json.loads(line) for line in out.stdout.splitlines()
                  if line.startswith("{"))["fleet_child"]
    cfg = full_width_config()
    _check_counts("fleet child", report["launches"],
                  {"flash_fwd": cfg.n_layers * FLEET["STEPS"], "dq": 0, "dkv": 0,
                   "flash_decode": 0})
    nll = report["nll"]
    if not (report["finite"] and report["shape"] == [FULL["B"], FULL["L"], cfg.vocab]
            and 0 <= nll - math.log(cfg.vocab) < NLL_ABOVE_UNIFORM and report["published"]):
        raise RuntimeError(f"the fleet child's forwards or its publish: {report}")
    report["exec_to_cuda_ready_ms"] = (report["ready_at"] - t_spawn) * 1e3
    return report


def phase_fleet(card: str, master_live: dict) -> int:
    """Phase 17: ``entry.fleet_check`` on the card (see the module's
    docstring), a line for each case. Returns the flash_fwd launches of the
    tenant child and the collection passes' ms."""
    t_phase = time.perf_counter()
    children = []

    def on_mounted(uuids, target, url, token):
        visible = gpus_visible_in_dev(target)
        if visible != 1:
            raise RuntimeError(f"gpus_visible_in_dev({target}) = {visible} after the add of "
                               f"{uuids}")
        children.append(_fleet_tenant(uuids[0], url, token))
        return {"tenant": children[-1]["tenant"], "steps": children[-1]["steps"]}

    with _tenant_target("phase17") as (dev_dir, cgroup_dir):
        report = fleet_check("cuda", dev_dir=dev_dir, ns_pid=os.getpid(),
                             cgroup_dirs=[cgroup_dir] if cgroup_dir else (),
                             identity=pick_identity(), repeats=MOUNT["REPEATS"],
                             on_mounted=on_mounted)
    f = report["live"]
    if f is None or len(children) != 1:
        raise RuntimeError(f"phase 17 ran no live flows with their tenant child on the card: "
                           f"live {f is not None}, {len(children)} child(ren)")
    child = children[0]
    med = statistics.median
    node, tr = f["node"], f["trace"]
    print(f"time fleet (a) {len(f['add_ms'])} live HTTP adds {_runs(f['add_ms'])}, removes "
          f"{_runs(f['remove_ms'])}; phase 11's add {_runs(master_live['add_ms'])} [{card}]",
          flush=True)
    print(f"time fleet (b) the tenant child on {child['uuid']} ({child['device']}): "
          f"{child['steps']} forwards through flash_fwd ({child['launches']['flash_fwd']} "
          f"launches), steps {_runs(child['step_ms'])}, nll {child['nll']:.4f}, exec to CUDA "
          f"ready {child['exec_to_cuda_ready_ms']:.1f} ms; its POST /tenant-telemetry "
          f"{child['publish_ms']:.3f} ms; /tenants lists {child['tenant']} on "
          f"{f['tenant_seen']['node']} with {f['tenant_seen']['steps']} step(s), "
          f"{f['tenant_seen']['tokens_per_s']:.0f} tokens/s [{card}]", flush=True)
    print(f"time fleet (c) collection pass over CollectTelemetry {_runs(f['collect_ms'])}; "
          f"/fleet's {node['mode']} node: {node['mount']['count']} mounts in the process, "
          f"p50 {node['mount']['p50_ms']} ms, p95 {node['mount']['p95_ms']} ms, this phase's "
          f"{len(f['add_ms'])} adds among them, the total the nodes' sum; the exemplar "
          f"{f['exemplar']} (an add's trace) in /fleet and in /metrics as OpenMetrics; "
          f"/trace/<first add> complete, {tr['remote_spans']} span(s) federated through the "
          f"remote store, wall {tr['wall_ms']:.3f} ms, phases {tr['phases']} (sum within "
          f"max(2 ms, 5%)), dominant {tr['dominant']['phase']} "
          f"({tr['dominant']['share']:.0%}); one /trace/<id> assembly "
          f"{_runs(f['trace_ms'])} [{card}]", flush=True)
    print(f"time fleet (c) /slo over the phase's adds (windows {FLEET_SLO_WINDOW_S} s): "
          f"{f['slo']}; breach Events {f['breach_messages']} [{card}]", flush=True)
    scopes = f["scopes"]
    print(f"time fleet (c) the read scope: the read token on /addgpu "
          f"{scopes['read_on_add']}, on POST /tenant-telemetry "
          f"{scopes['read_on_tenant_post']}; without a token "
          f"{sorted(set(scopes['no_token'].values()))} on all {len(scopes['no_token'])} reads "
          f"of both daemons [{card}]", flush=True)
    c, sc = f["costs"], f["scrape"]
    add_ms = med(master_live["add_ms"])
    print(f"time fleet (c) costs, medians of {len(c['call_ms'])}: one CollectTelemetry call "
          f"{_runs(c['call_ms'])} with {med(c['payload_bytes']):.0f} bytes of payload; one "
          f"POST /tenant-telemetry {_runs(c['post_ms'])}; one snapshot "
          f"{med(c['snapshot_us']):.1f} us, "
          f"{100 * med(c['snapshot_us']) / 1e3 / add_ms:.3f}% of phase 11's add "
          f"({add_ms:.3f} ms; stated, not gated) [{card}]", flush=True)
    print(f"time fleet (d) a worker without CollectTelemetry: mode {sc['mode']}, "
          f"{sc['mount_count']:.0f} mounts and {sc['success']:.0f} successes as the RPC's "
          f"rollup, {sc['spans']} spans, tenants {sc['tenants']}; the scrape pass "
          f"{_runs(sc['scrape_ms'])} [{card}]", flush=True)
    print(f"time fleet phase 17: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return child["launches"]["flash_fwd"], f["collect_ms"]


def _holder_forward() -> dict:
    """Phase 3's first forward in this process, through flash_fwd, its
    launches counted: this process holds the card while the canary probes
    it. Held as a tenant's forward (``_check_tenant_forward``)."""
    report = _tenant_forward()
    _check_tenant_forward("phase 18's forward", report)
    return {"launches": report["launches"]["flash_fwd"], "nll": report["nll"],
            "ms": report["ms"]}


def phase_health(card: str, master_live: dict) -> int:
    """Phase 18: ``entry.health_check`` on the card (see the module's
    docstring), a line for each case. Returns the flash_fwd launches of the
    forward that holds the card."""
    t_phase = time.perf_counter()
    ledger_root = os.path.dirname(os.path.abspath(__file__))
    with _tenant_target("phase18") as (dev_dir, _cgroup_dir):
        report = health_check("cuda", dev_dir=dev_dir, ns_pid=os.getpid(),
                              identity=pick_identity(), ledger_root=ledger_root,
                              before_canary=_holder_forward)
    h = report["live"]
    if h is None:
        raise RuntimeError("phase 18 ran no live flows on the card")
    m, sc, d = h["manual"], h["scored"], h["death"]
    fwd, clean, vanished = m["before_canary"], m["clean"], m["vanished"]
    chip, lost = clean["probe"]["chips"][0], vanished["probe"]["chips"][0]
    print(f"time health (a) the node quarantined by hand (POST /health/quarantine, "
          f"{m['quarantine_ms']:.3f} ms); this process's forward through flash_fwd "
          f"({fwd['launches']} launches, {fwd['ms']:.1f} ms, nll {fwd['nll']:.4f}) holds the "
          f"card; the canary (add, ProbeGPU, remove) {clean['ms']:.3f} ms against phase 11's "
          f"add {_runs(master_live['add_ms'])}: {chip['uuid']} healthy, holder_count "
          f"{chip['holder_count']}, mounted {clean['mounted']}, then unmounted; with the node "
          f"deleted between the add and the probe ({vanished['ms']:.3f} ms): healthy "
          f"{lost['healthy']}, {lost['reason']!r}, the plane's canary failures "
          f"{vanished['canary']['consecutive_failures']} ({vanished['canary']['detail']!r}) "
          f"[{card}]", flush=True)
    print(f"time health (b) one collection pass after the quarantine "
          f"({m['pass_ms']:.3f} ms) drained the warm pool ({m['drained']:.0f} holder, ready 0); "
          f"released by hand, the pool refilled in {m['refill_ms']:.3f} ms; two dropped "
          f"attempts of a live add opened the breaker, and the passes took the node through "
          f"{sc['states']} (clean canaries {_runs(sc['canary_ms'])}); the flight recorder's "
          f"health records: {[(r['from'], r['to'], r['signals']) for r in h['records']]} "
          f"[{card}]", flush=True)
    print(f"time health (c) a worker's death (the worker a child process, pid {d['pid']}, "
          f"serving {d['spawn_ms']:.1f} ms after its start, killed with SIGKILL; its pod "
          f"deleted, its Node NotReady): the live add through it "
          f"{d['add_ms']:.3f} ms; the kill to the evacuation {d['evacuation_ms']:.3f} ms over "
          f"{d['passes']} recovery pass(es) ({d['reason']}); released {d['released']}, listed "
          f"by /recovery; the release refused: {d['release_refused']!r} [{card}]", flush=True)
    print(f"time health phase 18: {time.perf_counter() - t_phase:.1f} s (the stack's start "
          f"{h['start_ms']:.1f} ms) [{card}]", flush=True)
    return fwd["launches"]


def phase_elastic_migrate(card: str, master_live: dict) -> int:
    """Phase 19: ``entry.elastic_migrate_check`` on the card (see the module's
    docstring), a line for each case. Returns the flash_fwd launches of the
    two tenants (the source's forward and the destination's after the
    restore)."""
    t_phase = time.perf_counter()
    cfg = full_width_config()
    tenant = {"model": {"vocab": cfg.vocab, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                        "n_layers": cfg.n_layers, "d_ff": cfg.d_ff, "max_len": cfg.max_len,
                        "rope": cfg.rope},
              "tokens": [FULL["B"], FULL["L"]]}
    ledger_root = os.path.dirname(os.path.abspath(__file__))
    with _tenant_target("phase19") as (dev_dir, _cgroup_dir):
        report = elastic_migrate_check("cuda", dev_dir=dev_dir, ns_pid=os.getpid(),
                                       identity=pick_identity(), ledger_root=ledger_root,
                                       tenant=tenant)
    f = report["live"]
    if f is None:
        raise RuntimeError("phase 19 ran no live flows on the card")
    h, m, rb = f["heal"], f["migration"], f["rollback"]
    src, dst = m["source"], m["destination"]
    for what, t in (("phase 19's source tenant", src), ("phase 19's destination tenant", dst)):
        if t["launches"] != cfg.n_layers or t["shape"] != [FULL["B"], FULL["L"], cfg.vocab] \
                or not 0 <= t["nll"] - math.log(cfg.vocab) < NLL_ABOVE_UNIFORM:
            raise RuntimeError(f"{what}'s forward: {t}")
    print(f"time elastic (a) PUT /intents {h['put_ms']:.3f} ms; the reconciler's pass grew "
          f"the pod to {h['uuid']} in {h['grow_ms']:.3f} ms (phase 11's add "
          f"{_runs(master_live['add_ms'])}); its node deleted from the target's /dev, ProbeGPU "
          f"answered healthy {h['vanished']['healthy']} ({h['vanished']['reason']!r}); the "
          f"heal (force-remove, grow, probe) {h['heal_ms']:.3f} ms: removed "
          f"{h['outcome']['removed_dead']}, added {h['outcome']['added']}, chip-replaced "
          f"generation {h['marker']['generation']}, the elastic.heal record, the Event "
          f"{h['event']!r}, tpumounter_chips_healed_total + 1; the torchside heal watcher fired "
          f"once [{card}]", flush=True)
    print(f"time elastic (b) the tenants (processes on the GPU) watching their pods "
          f"{m['tenants_ready_ms']:.1f} ms from their start; the source's forward through "
          f"flash_fwd ({src['launches']} launches, {src['forward_ms']:.1f} ms, nll "
          f"{src['nll']:.4f}); POST /migrate (checkpoint) {m['begin_ms']:.3f} ms; the source "
          f"packed in {src['pack_ms']:.1f} ms and saved in {src['save_ms']:.1f} ms; the "
          f"destination loaded in {dst['load_ms']:.1f} ms, restored in {dst['restore_ms']:.1f} "
          f"ms and ran the forward ({dst['launches']} launches, {dst['forward_ms']:.1f} ms): its "
          f"logits' sha256 {dst['sha256'][:16]} equal to the source's; phases (s) "
          f"{m['phases_s']}, downtime {m['downtime_s']} s; /trace/<id> holds "
          f"{[n for n in m['spans'] if n.startswith(('migrate.', 'http.'))]} [{card}]",
          flush=True)
    print(f"time elastic (c) migrate.phase.verify armed: rolled back in {rb['wait_ms']:.3f} ms "
          f"(phases (s) {rb['phases_s']}), the Event {rb['event']!r}; books == ledger == "
          f"mounts {rb['books']} [{card}]", flush=True)
    d = f["defrag"]
    print(f"time elastic (d) GET /defrag {d['get_ms']:.3f} ms; POST /defrag/plan "
          f"{d['plan_ms']:.3f} ms (block {d['target_block']}, no move, no blocked host, the "
          f"node's view {d['host']}); POST /defrag/run {d['run_ms']:.3f} ms, {d['status']} with "
          f"{d['moves']} moves {d['done_ms']:.3f} ms after it [{card}]", flush=True)
    print(f"time elastic phase 19: {time.perf_counter() - t_phase:.1f} s (the stack's start "
          f"{f['start_ms']:.1f} ms) [{card}]", flush=True)
    return m["launches"]


def phase_capacity_share(card: str, master_live: dict, fleet_pass_ms: list) -> int:
    """Phase 20: ``entry.capacity_share_check`` on the card (see the module's
    docstring), a line for each case; the metered share's tenant is a
    ``--mount-child`` on the shared GPU. Returns its flash_fwd launches."""
    t_phase = time.perf_counter()
    children = []

    def on_mounted(uuids, target):
        visible = gpus_visible_in_dev(target)
        if visible < 1:
            raise RuntimeError(f"gpus_visible_in_dev({target}) = {visible} with {uuids} "
                               f"mounted")
        children.append(_tenant_child(uuids[0]))
        return {k: children[-1][k] for k in ("uuid", "launches", "nll")}

    ledger_root = os.path.dirname(os.path.abspath(__file__))
    with _tenant_target("phase20") as (dev_dir, cgroup_dir):
        report = capacity_share_check("cuda", dev_dir=dev_dir, ns_pid=os.getpid(),
                                      cgroup_dirs=[cgroup_dir] if cgroup_dir else (),
                                      identity=pick_identity(), ledger_root=ledger_root,
                                      on_mounted=on_mounted)
    f = report["live"]
    if f is None or len(children) != 1:
        raise RuntimeError(f"phase 20 ran no live flows with their tenant child on the card: "
                           f"live {f is not None}, {len(children)} child(ren)")
    child, inv, held = children[0], f["inventory"], f["held"]
    add_ms = statistics.median(master_live["add_ms"])
    snap_ms = statistics.median(f["snapshot_us"]) / 1e3
    print(f"time capacity (a) a collection pass {f['pass_ms']:.3f} ms (phase 17's passes "
          f"{_runs(fleet_pass_ms)}); /capacity: {inv['total']} GPU(s), free {inv['free']}, "
          f"the fleet's index {inv['index']}; nvidia-h100-80gb-1 "
          f"{inv['verdicts']['nvidia-h100-80gb-1']} and tracked, no multi-host size tracked; "
          f"the capacity snapshot {snap_ms * 1e3:.1f} us (runs "
          f"{', '.join(f'{v:.1f}' for v in f['snapshot_us'])}), {100 * snap_ms / add_ms:.3f}% "
          f"of phase 11's add ({add_ms:.3f} ms; stated, not gated) [{card}]", flush=True)
    print(f"time capacity (b) POST /shares {f['admit_ms']:.3f} ms booked {SHARE['pod']} "
          f"({SHARE['profile']}, weight {SHARE['weight']}, budget {SHARE['rate_budget']}); "
          f"AddGPU with share_weight {SHARE['weight']} and share_rate_budget "
          f"{SHARE['rate_budget']} {f['add_ms']:.3f} ms; books {f['ledgers']['books']} == "
          f"ledger {f['ledgers']['ledger']} == engine {f['ledgers']['engine']} (invariant 19); "
          f"the throttle alike in the engine and the device program {f['throttle']}; the "
          f"tenant child on {child['uuid']} ({child['device']}): exec to CUDA ready "
          f"{child['exec_to_cuda_ready_ms']:.1f} ms, flash_fwd "
          f"{child['launches']['flash_fwd']} launches, nll {child['nll']:.4f} [{card}]",
          flush=True)
    print(f"time capacity (c) a pass {f['held_pass_ms']:.3f} ms; /capacity reads the GPU held "
          f"by {held['owners']}, the headroom {held['forecast']}, slice_feasible "
          f"+{held['slice_feasible']:.0f}, slice_infeasible +{held['slice_infeasible']:.0f}; "
          f"the shares' view {held['shares']} [{card}]", flush=True)
    print(f"time capacity (d) a second pod's /addgpu answered 500 in {f['refused_ms']:.3f} ms "
          f"with capacity.reject ({f['rejection']['cause']}): {f['rejection']['outcome']!r}, "
          f"on /timeline too [{card}]", flush=True)
    regrant = f["regrant"]
    print(f"time capacity (e) POST /shares on the tenant's own GPU: 409; the re-grant at weight "
          f"{SHARE_REGRANT_WEIGHT} (ShareRegistry.add) {f['regrant_us']:.1f} us, books-only as "
          f"the reference's: books {regrant['books']}, ledger {regrant['ledger']}, engine "
          f"{regrant['engine']}, no program swap; the forced remove {f['remove_ms']:.3f} ms and "
          f"DELETE /shares {f['release_ms']:.3f} ms cleared the three ledgers; /capacity reads "
          f"free {f['freed']} again [{card}]", flush=True)
    print(f"time capacity phase 20: {time.perf_counter() - t_phase:.1f} s (the stack's start "
          f"{f['start_ms']:.1f} ms) [{card}]", flush=True)
    return child["launches"]["flash_fwd"]


def _autoscale_child(spec: dict) -> None:
    """The tenant of phase 21, started with CUDA_VISIBLE_DEVICES=<the UUID
    the worker assigned>: CUDA's one device must be that GPU; then, for each
    window's B, spec["steps"] full-width forwards (phase 3's weights) of B
    random rows of L tokens through flash_fwd, each a ``TenantTelemetry``
    step of B * L tokens at spec["queue"] timed on the host clock, its
    forward between two CUDA events and, on the host clock, the forward's
    call until it returns (its launches queued); after the window the snapshot is
    POSTed to the worker's ops port, the last step's logits are held
    against the plain-attention forward of the same tokens, a JSON line is
    printed and a line of stdin awaited (the check's collection pass).
    Prints one JSON line of its report last; a failure raises (exit code
    1)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.init()
    props = torch.cuda.get_device_properties(0)
    torch.cuda.synchronize()
    t_ready = time.time()
    uuid = f"GPU-{props.uuid}"
    if uuid != spec["uuid"] or torch.cuda.device_count() != 1:
        raise RuntimeError(f"CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r}: "
                           f"{torch.cuda.device_count()} device(s), device 0 is {uuid}, the "
                           f"worker assigned {spec['uuid']}")
    cfg = full_width_config()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    tel = TenantTelemetry(spec["tenant"], namespace=spec["namespace"], pod=spec["pod"],
                          token=os.environ[TENANT_TOKEN_ENV])
    _reset_kernel_counts()
    windows, nll, finite = [], [], True
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for b in spec["windows"]:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, FULL["L"]))).cuda()
        step_ms, device_ms, enqueue_ms = [], [], []
        for _ in range(spec["steps"]):
            t0 = time.perf_counter()
            with tel.step(tokens=float(tokens.numel()), queue_depth=spec["queue"]):
                start.record()
                t1 = time.perf_counter()
                logits = forward(params, tokens, cfg)
                enqueue_ms.append((time.perf_counter() - t1) * 1e3)
                end.record()
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            device_ms.append(start.elapsed_time(end))
        published = tel.publish(spec["url"])
        tokens_per_s = tel.snapshot()["tokens_per_s"]
        # the last step's logits against the plain-attention forward, after
        # the publish and outside the timed steps (no kernel launch)
        finite = finite and bool(torch.isfinite(logits).all())
        vs_plain = _vs_plain(cfg, params, tokens, logits)
        nll.append(vs_plain["nll"])
        del logits
        windows.append({"B": b, "tokens_per_s": tokens_per_s, "step_ms": step_ms,
                        "device_ms": device_ms, "enqueue_ms": enqueue_ms, "vs_plain": vs_plain,
                        "published": published})
        print(json.dumps({"window": len(windows) - 1, "published": published}), flush=True)
        if not sys.stdin.readline():
            raise RuntimeError("the check closed the tenant's stdin before its last window")
    print(json.dumps({"autoscale_child": {
        "ready_at": t_ready, "uuid": uuid, "device": torch.cuda.get_device_name(0),
        "launches": _kernel_counts(), "nll": nll, "finite": finite, "vocab": cfg.vocab,
        "tenant": spec["tenant"], "steps": spec["steps"] * len(windows),
        "windows": windows}}), flush=True)


def _autoscale_tenant(uuid: str, url: str, token: str, collect) -> dict:
    """Run the autoscale child on `uuid`, publishing to `url`, and collect()
    after each of its windows; check its device, launches (n_layers a step),
    NLL, publishes, and each window's logits against the plain-attention
    forward (LOGITS_RTOL_OF_MAX, NLL_ATOL). Returns its report with
    exec_to_cuda_ready_ms."""
    spec = {"uuid": uuid, "url": url, "tenant": "default/tenant-autoscale",
            "namespace": "default", "pod": "tenant-autoscale",
            "windows": list(AUTOSCALE_WINDOWS), "steps": AUTOSCALE_STEPS,
            "queue": AUTOSCALE_QUEUE}
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": uuid, TENANT_TOKEN_ENV: token}
    with tempfile.TemporaryFile("w+") as err:
        t_spawn = time.time()
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--autoscale-child", json.dumps(spec)],
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
                                text=True, env=env)
        watchdog = threading.Timer(600.0, proc.kill)
        watchdog.start()
        try:
            lines = []
            for _ in spec["windows"]:
                while True:
                    line = proc.stdout.readline()
                    if not line:
                        raise RuntimeError(f"the autoscale child ended before its window "
                                           f"{len(lines)}")
                    if line.startswith('{"window"'):
                        lines.append(json.loads(line))
                        break
                collect()
                proc.stdin.write("\n")
                proc.stdin.flush()
            rest = proc.stdout.read()
            code = proc.wait()
        except Exception as exc:
            proc.kill()
            proc.wait()
            err.seek(0)
            raise RuntimeError(f"the autoscale child: {exc}\n{err.read()[-4000:]}") from exc
        finally:
            watchdog.cancel()
        if code != 0:
            err.seek(0)
            raise RuntimeError(f"autoscale child exited {code}:\n{rest[-2000:]}\n"
                               f"{err.read()[-4000:]}")
    report = next(json.loads(line) for line in rest.splitlines()
                  if line.startswith('{"autoscale_child"'))["autoscale_child"]
    cfg = full_width_config()
    _check_counts("autoscale child", report["launches"],
                  {"flash_fwd": cfg.n_layers * report["steps"], "dq": 0, "dkv": 0,
                   "flash_decode": 0})
    if not (report["finite"] and all(0 <= v - math.log(report["vocab"]) < NLL_ABOVE_UNIFORM
                                     for v in report["nll"])
            and all(w["published"] for w in report["windows"])):
        raise RuntimeError(f"the autoscale child's forwards or its publishes: {report}")
    for w in report["windows"]:
        _check_vs_plain(f"the autoscale child's window B{w['B']}", w["vs_plain"])
    report["exec_to_cuda_ready_ms"] = (report["ready_at"] - t_spawn) * 1e3
    return report


def phase_autoscale(card: str) -> int:
    """Phase 21: ``entry.autoscale_check`` on the card (see the module's
    docstring), a line for each part. Returns the flash_fwd launches of the
    tenant child."""
    t_phase = time.perf_counter()
    children = []

    def on_mounted(uuids, target, url, token, collect):
        visible = gpus_visible_in_dev(target)
        if visible != 1:
            raise RuntimeError(f"gpus_visible_in_dev({target}) = {visible} after the add of "
                               f"{uuids}")
        children.append(_autoscale_tenant(uuids[0], url, token, collect))
        return {k: children[-1][k] for k in ("tenant", "steps", "windows")}

    ledger_root = os.path.dirname(os.path.abspath(__file__))
    with _tenant_target("phase21") as (dev_dir, cgroup_dir):
        report = autoscale_check("cuda", dev_dir=dev_dir, ns_pid=os.getpid(),
                                 cgroup_dirs=[cgroup_dir] if cgroup_dir else (),
                                 identity=pick_identity(), ledger_root=ledger_root,
                                 on_mounted=on_mounted)
    f = report["live"]
    if f is None or len(children) != 1:
        raise RuntimeError(f"phase 21 ran no live flows with their tenant child on the card: "
                           f"live {f is not None}, {len(children)} child(ren)")
    child, fit = children[0], f["fit"]
    med = statistics.median
    print(f"time autoscale (a) HTTP add {f['add_ms']:.3f} ms, PUT /intents {f['put_ms']:.3f} ms; "
          f"the tenant child on {child['uuid']} ({child['device']}): exec to CUDA ready "
          f"{child['exec_to_cuda_ready_ms']:.1f} ms, {child['steps']} forwards through "
          f"flash_fwd ({child['launches']['flash_fwd']} launches), nll "
          f"{', '.join(f'{v:.4f}' for v in child['nll'])} [{card}]", flush=True)
    for w in child["windows"]:
        host, dev, p = med(w["step_ms"]), med(w["device_ms"]), w["vs_plain"]
        print(f"time autoscale (a) window B{w['B']} L{FULL['L']}: {len(w['step_ms'])} steps, "
              f"median step {host:.3f} ms (min {min(w['step_ms']):.3f}, max "
              f"{max(w['step_ms']):.3f}), its forward between CUDA events median "
              f"{dev:.3f} ms (min {min(w['device_ms']):.3f}, max {max(w['device_ms']):.3f}), "
              f"the forward's call until its launches are queued median "
              f"{med(w['enqueue_ms']):.3f} ms (host clock); published tokens/s "
              f"{w['tokens_per_s']:.1f}; the last step's logits vs the plain-attention "
              f"forward max abs err {p['err']:.3g} (limit {p['limit']:.3g}), nll {p['nll']:.4f} "
              f"vs {p['nll_plain']:.4f} [{card}]", flush=True)
    vs = f["fit_vs_windows"]
    vs_windows = ", ".join(f"B{r['B']} {r['predicted']:.1f}/{r['rate']:.1f}"
                           for r in vs["windows"])
    print(f"time autoscale (b) collection passes {_runs(f['collect_ms'])}; GET /autoscale "
          f"{f['get_ms']:.3f} ms: {child['tenant']} fit {fit['verdict']} on {fit['samples']} "
          f"samples, r_max {fit['r_max']} tokens/s, b_half {fit['b_half']} tokens, rmse "
          f"{fit['rmse']}, utilization {fit['utilization']} (last batch {fit['last_batch']}, "
          f"last rate {fit['last_rate']}); against its windows: predicted/published "
          f"{vs_windows}, largest gap {max(r['rel_err'] for r in vs['windows']):.4f}, r_max "
          f"{vs['r_max_over_seen']:.3f} x the fastest (both reported, not gated), numpy's "
          f"refit within {vs['refit_err']:.3g} (limit {AUTOSCALE_REFIT_RTOL}) [{card}]",
          flush=True)
    ev, pause = f["evaluate"], f["pause"]
    evaluate_ms = ", ".join(f"{e['ms']:.3f}" for e in ev)
    print(f"time autoscale (c) POST /autoscale/evaluate x2 "
          f"{evaluate_ms} ms: {[e['reason'] for e in ev]} (the "
          f"rule's {f['expected']}; the second's feasibility {ev[-1]['feasibility']}), intent "
          f"and mount unchanged; pause {pause['pause'][0]}, evaluate while paused "
          f"{pause['paused'][0]} ({pause['paused'][1]:.3f} ms), resume {pause['resume'][0]}, "
          f"evaluate {pause['resumed'][0]} ({pause['resumed'][1]:.3f} ms); remove "
          f"{f['remove_ms']:.3f} ms [{card}]", flush=True)
    print(f"time autoscale phase 21: {time.perf_counter() - t_phase:.1f} s (the stack's start "
          f"{f['start_ms']:.1f} ms) [{card}]", flush=True)
    return child["launches"]["flash_fwd"]


def phase_cli(card: str, master_live: dict) -> int:
    """Phase 22: the operator's verbs against the live stack,
    ``entry.cli_check`` on the card (each verb ``python -m
    gpumounter_tpu_torch.cli`` in a process of its own, every exit code
    asserted): `devices --busy` names CUDA's UUID and this process among
    its holders, `probe` the identity source this script picked, `add`
    mounts the card's GPU into the same kind of target as phase 10 and a
    tenant child runs phase 3's forward through flash_fwd on that UUID
    (held against the plain-attention forward), then `audit`, `trace`,
    `why`, `capacity`, the refusals, `remove`, `fleet`, `apihealth` and
    `shards`. Its times beside phase 11's HTTP add and remove. Returns the
    flash_fwd launches of the tenant child."""
    t_phase = time.perf_counter()
    identity = pick_identity()
    children = []

    def on_mounted(uuids, target):
        visible = gpus_visible_in_dev(target)
        if visible != 1:
            raise RuntimeError(f"gpus_visible_in_dev({target}) = {visible} after the CLI's add "
                               f"of {uuids}")
        children.append({**_tenant_child(uuids[0]), "visible_in_dev": visible})
        return children[-1]["uuid"]

    with _tenant_target("phase22") as (dev_dir, cgroup_dir):
        report = cli_check("cuda", dev_dir=dev_dir, ns_pid=os.getpid(),
                           cgroup_dirs=[cgroup_dir] if cgroup_dir else (), identity=identity,
                           repeats=MOUNT["REPEATS"], on_mounted=on_mounted)
    c = report["live"]
    if c["refusal"] is not None:
        # without CAP_MKNOD the add is refused and rolled back, as in phase 11:
        # the tenant child runs on the card's own UUID
        children.append({**_tenant_child(c["devices"]["uuid"]), "visible_in_dev": None})
    if len(children) != 1:
        raise RuntimeError(f"phase 22 ran {len(children)} tenant children, one expected")
    child, dev, probe = children[0], c["devices"], c["probe"]
    print(f"cli devices --busy: {dev['path']} {dev['major']}:{dev['minor']} {dev['uuid']} "
          f"(CUDA's device 0), holders {dev['holder_pids']} include this process "
          f"({os.getpid()}), as the backend's /proc scan finds them; probe: {probe} "
          f"(identity source picked here: {identity}) [{card}]", flush=True)
    if c["refusal"] is None:
        cap = c["capacity"]
        print(f"cli add --num 1 (tenant-cli-1) exit 0 'Add GPU Success', mounting {c['uuids']} "
              f"(gpus_visible_in_dev read {child['visible_in_dev']}); audit --pod shows http.add "
              f"and worker.AddGPU under trace {c['trace_id']}; trace exit 0; why exit 0, "
              f"dominant phase {c['dominant']}; trace of 32 zeros exit 2; capacity exit 0 with "
              f"the GPU held (fleet {cap['fleet']}), --accel-type {CLI_SHAPE} {cap['verdict']} "
              f"exit {cap['exit']}, --accel-type {CLI_UNKNOWN_SHAPE} exit 2; add --num 2 exit 1 "
              f"(500 Insufficient), add --token '' exit 1 (401); remove exit 0, the node gone "
              f"and the slave pod released; fleet, apihealth, shards exit 0; "
              f"{MOUNT['REPEATS']} CLI round trips [{card}]", flush=True)
    else:
        print(f"cli add refused, exit 1, {c['refusal']!r}; rolled back, {MOUNT['REPEATS']} "
              f"times; audit, trace of 32 zeros, fleet, apihealth, shards as expected [{card}]",
              flush=True)
    p = child["vs_plain"]
    print(f"cli tenant: CUDA_VISIBLE_DEVICES={child['uuid']} gives device 0 {child['device']}; "
          f"full-width forward through flash_fwd, launches {child['launches']}, nll "
          f"{child['nll']:.4f}, logits vs the plain-attention forward max abs err "
          f"{p['err']:.3g} (limit {p['limit']:.3g}), nll vs {p['nll_plain']:.4f}; bit-equal to "
          f"phase 3's logits: {child['sha256'] == PHASE3_LOGITS['sha256']} [{card}]",
          flush=True)
    print(f"time cli import of gpumounter_tpu_torch.cli alone (python -c, torch, numpy and "
          f"grpc not loaded): {_runs(report['import_ms'])} [{card}]", flush=True)
    print("time cli verbs, spawn to exit: " + "; ".join(
        f"{name} {_runs(ms)}" for name, ms in c["verb_ms"].items()) + f" [{card}]", flush=True)
    print(f"time cli add {_runs(c['cli_add_ms'])}, remove "
          f"{_runs(c['cli_remove_ms']) if c['cli_remove_ms'] else '(none)'}; the same stack's "
          f"HTTP add from this process "
          f"{_runs(c['http_add_ms']) if c['http_add_ms'] else '(none)'}, remove "
          f"{_runs(c['http_remove_ms']) if c['http_remove_ms'] else '(none)'}; phase 11's HTTP "
          f"add {_runs(master_live['add_ms'])}"
          + (f", remove {_runs(master_live['remove_ms'])}" if master_live["remove_ms"] else "")
          + f" [{card}]", flush=True)
    print(f"time cli tenant exec -> CUDA ready: {child['exec_to_cuda_ready_ms']:.1f} ms; its "
          f"forward {child['ms']:.1f} ms [{card}]", flush=True)
    print(f"time cli phase 22: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return child["launches"]["flash_fwd"]


def _counted(fn, total: dict) -> tuple:
    """(fn(), its launches): the counts set to 0 just before fn and read
    just after; each count is added to `total`."""
    _reset_kernel_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = _kernel_counts()
    _add_launches(total, launches)
    return out, launches


def _graph_steps(cfg, params, batches, card, launches: dict) -> None:
    """Phase 23 (a): the captured SGD steps against the eager ones."""
    what = "MoE" if cfg.n_experts else "dense"
    captured, eager = make_train_step(cfg, TRAIN["LR"]), make_train_step(cfg, TRAIN["LR"], capture=False)
    before = graphs.capture.captures

    def steps(step, first_ms=None):
        p, out = params, []
        for i, tokens in enumerate(batches):
            if i == 0 and first_ms is not None:
                ms, (p, loss) = _host_ms(lambda: step(p, tokens))
                first_ms.append(ms)
            else:
                p, loss = step(p, tokens)
            out.append((loss, p))
        return out

    first_ms = []
    got, counts = _counted(lambda: steps(captured, first_ms), launches)
    want, eager_counts = _counted(lambda: steps(eager), {})
    if counts != eager_counts or graphs.capture.captures - before != 1:
        raise RuntimeError(f"{what} captured steps: launches {counts} (eager {eager_counts}), "
                           f"{graphs.capture.captures - before} captures, expected 1")
    for i, ((loss, p), (want_loss, w)) in enumerate(zip(got, want)):
        bad = [n for n, a, b in zip(tree_names(p), tree_leaves(p), tree_leaves(w)) if not torch.equal(a, b)]
        if bad or not torch.equal(loss, want_loss):
            raise RuntimeError(f"{what} captured step {i}: loss {loss.item()} vs eager "
                               f"{want_loss.item()}, leaves not bit-equal: {bad}")
    tokens = batches[0]
    step_ms = _time_ms(lambda: captured(params, tokens), GRAPHS["RUNS"], warmup=0)
    eager_ms = _time_ms(lambda: eager(params, tokens), GRAPHS["RUNS"], warmup=1)
    device_ms = _time_ms(graphs.cached("train_step").graph.replay, GRAPHS["RUNS"], warmup=1)
    print(f"graphs {what} SGD step B{tokens.shape[0]} L{tokens.shape[1]}: {len(batches)} captured "
          f"steps bit-equal to eager (loss and {len(tree_leaves(params))} leaves each), 1 capture, "
          f"launches {counts} = eager's; captured {step_ms:.3f} ms, eager {eager_ms:.3f} ms (CUDA "
          f"events, {GRAPHS['RUNS']} calls); first call with its capture {first_ms[0]:.1f} ms "
          f"(host clock); the graph's replay alone {device_ms:.3f} ms (device ms; the copies in "
          f"and out {step_ms - device_ms:.3f} ms) [{card}]", flush=True)


def _graph_forwards(cfg, params, card, launches: dict) -> None:
    """Phase 23 (b): the captured forward against the eager one at each B."""
    what = "MoE" if cfg.n_experts else "dense"
    rng = np.random.default_rng(GRAPHS["SEED"])
    for b in GRAPHS["FORWARD_B"]:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, FULL["L"]))).cuda()
        eager_runs = [_host_ms(lambda: forward(params, tokens, cfg, capture=False))
                      for _ in range(GRAPHS["RUNS"])]
        want = eager_runs[0][1]
        before = graphs.capture.captures
        (first_ms, first), counts = _counted(lambda: _host_ms(lambda: forward(params, tokens, cfg)),
                                             launches)
        runs = [_host_ms(lambda: forward(params, tokens, cfg)) for _ in range(GRAPHS["RUNS"])]
        if counts["flash_fwd"] != cfg.n_layers or graphs.capture.captures - before != 1:
            raise RuntimeError(f"{what} forward B{b}: launches {counts}, "
                               f"{graphs.capture.captures - before} captures, expected "
                               f"{cfg.n_layers} and 1")
        unequal = [i for i, (_, out) in enumerate([(first_ms, first)] + runs)
                   if not torch.equal(out, want)]
        if unequal:
            raise RuntimeError(f"{what} forward B{b}: calls {unequal} (0 the first) differ from "
                               f"the eager forward's logits")
        device_ms = _time_ms(graphs.cached("forward").graph.replay, GRAPHS["RUNS"], warmup=1)
        captured_ms = statistics.median(ms for ms, _ in runs)
        print(f"graphs {what} forward B{b} L{FULL['L']}: logits bit-equal to eager (the first "
              f"call and {len(runs)} replays), 1 capture; host ms (the call until the device is "
              f"done) captured {_runs([ms for ms, _ in runs])}, eager "
              f"{_runs([ms for ms, _ in eager_runs])}, the first call with its capture "
              f"{first_ms:.3f} ms; the graph's replay alone {device_ms:.3f} ms = "
              f"{tokens.numel() / (device_ms / 1e3):.0f} tokens/s (device), captured "
              f"{tokens.numel() / (captured_ms / 1e3):.0f} tokens/s (host) [{card}]", flush=True)
        del want, first, runs, eager_runs


def _graph_generate(cfg, params, card, launches: dict) -> None:
    """Phase 23 (c): generate's first and second call against the eager
    loop."""
    what = "MoE" if cfg.n_experts else "dense"
    rng = np.random.default_rng(GRAPHS["SEED"] + 1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE["B"], SERVE["T0"]))).cuda()
    n_new = SERVE["N_NEW"]
    calls = []
    for _ in range(2):
        before = graphs.capture.captures
        (ms, tokens), counts = _counted(lambda: _host_ms(lambda: generate(params, prompt, cfg, n_new)),
                                        launches)
        calls.append((ms, tokens, counts, graphs.capture.captures - before))
    eager_ms, eager = _host_ms(lambda: generate_loop(params, prompt, cfg, n_new, capture=False))
    want = {"flash_fwd": cfg.n_layers, "dq": 0, "dkv": 0, "flash_decode": cfg.n_layers * (n_new - 1)}
    if ([c[3] for c in calls] != [2, 0] or any(c[2] != want for c in calls)
            or not all(torch.equal(c[1], eager) for c in calls)):
        raise RuntimeError(f"{what} generate: captures {[c[3] for c in calls]} (expected 2, 0), "
                           f"launches {[c[2] for c in calls]} (expected {want}), tokens equal to "
                           f"the eager loop's {[torch.equal(c[1], eager) for c in calls]}")
    print(f"graphs {what} generate B{SERVE['B']} prompt {SERVE['T0']} n_new {n_new}: first call "
          f"{calls[0][0]:.1f} ms (2 captures: the prefill and the step), second {calls[1][0]:.1f} "
          f"ms (0 captures), the eager loop {eager_ms:.1f} ms (host clock); tokens of both calls "
          f"bit-equal to the eager loop's; launches {want} a call [{card}]", flush=True)


def phase_graphs(card: str) -> dict:
    """Phase 23: the reference's jitted programs as cached CUDA graphs
    (see the module's docstring), dense then MoE. Returns the captured
    runs' launches by kernel."""
    t_phase = time.perf_counter()
    clear_graphs()
    launches = dict.fromkeys(_kernel_counts(), 0)
    for n_experts in (None, MOE_EXPERTS):
        cfg = full_width_config(n_experts)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        rng = np.random.default_rng(GRAPHS["SEED"])
        batches = [torch.from_numpy(rng.integers(0, cfg.vocab, (TRAIN["B"], TRAIN["L"]))).cuda()
                   for _ in range(TRAIN["STEPS"])]
        _graph_steps(cfg, params, batches, card, launches)
        _graph_forwards(cfg, params, card, launches)
        _graph_generate(cfg, params, card, launches)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
        clear_graphs()
        freed = held - torch.cuda.memory_reserved()
        print(f"graphs {'MoE' if n_experts else 'dense'}: the cached programs (the train step, "
              f"forward at B{GRAPHS['FORWARD_B'][-1]}, generate) reserve {freed / 2**30:.3f} GiB, "
              f"handed back by clear_graphs() [{card}]", flush=True)
        del params, batches
    print(f"time graphs phase 23: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return launches


def phase_forward_timing(cfg, params, tokens, card, what="forward") -> None:
    fwd_ms = _time_ms(lambda: forward(params, tokens, cfg), 5, warmup=1)
    tok_s = tokens.numel() / (fwd_ms / 1e3)
    print(f"time {what} B{tokens.shape[0]} L{tokens.shape[1]}: {fwd_ms:.3f} ms, "
          f"{tok_s:.0f} tokens/s [{card}]", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--handoff-child"]:
        _handoff_child(json.loads(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--mount-child"]:
        _mount_child(json.loads(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--slice-child"]:
        _slice_child(json.loads(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--v2-child"]:
        _v2_child(json.loads(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--fleet-child"]:
        _fleet_child(json.loads(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--autoscale-child"]:
        _autoscale_child(json.loads(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    stages = ["1 (build)"]
    t0 = time.perf_counter()
    try:
        _phases(stages, t0)
    except Exception as err:
        message = f"chip_smoke: FAILED in phase {stages[-1]}: {type(err).__name__}: {err}"
        print(message, flush=True)
        print(message, file=sys.stderr, flush=True)
        raise
    return 0


def _phases(stage: list, t0: float) -> None:
    """Every phase in order; the name of each is appended to `stage` before
    it runs, so that a failure names it. t0: the script's start (host
    clock), for the whole run's time. Each phase's time (host clock) is
    printed as the next begins."""
    began = [t0]

    def begin(name: str) -> None:
        now = time.perf_counter()
        print(f"time phase {stage[-1]}: {now - began[0]:.1f} s", flush=True)
        began[0] = now
        stage.append(name)

    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    kernel_build_s = phase_build(card)
    begin("2 (kernels against their plain versions)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_abs_err = phase_kernel_vs_plain(gen)
    decode_err = phase_decode_vs_plain(gen)
    bwd_errs = phase_bwd_vs_plain(gen)

    begin("3 (dense main paths: forward, serving)")
    cfg = full_width_config()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab, (FULL["B"], FULL["L"]))).cuda()
               for _ in range(3)]
    launches = phase_main_path(cfg, params, batches)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE["B"], SERVE["T0"]))).cuda()
    prefill_launches, decode_launches, tokens, ref = phase_serving(cfg, params, prompt)
    begin("4 (captured decode step, then the MoE paths)")
    graph_step_ms = phase_graph(cfg, params, tokens, ref, card)
    del ref
    begin("3 (dense training)")
    train_fwd, train_dq, train_dkv = phase_train(cfg, params, batches)

    begin("4 (the MoE paths)")
    moe_cfg = full_width_config(n_experts=MOE_EXPERTS)
    moe_params = init_params(moe_cfg, torch.Generator().manual_seed(0), "cuda")
    moe_ffn_err = phase_moe_ffn_vs_plain(gen)
    moe_launches = phase_moe_forward(moe_cfg, moe_params, batches)
    moe_prefill, moe_decode, moe_tokens, moe_ref = phase_moe_serving(moe_cfg, moe_params, prompt)
    moe_graph_ms = phase_graph(moe_cfg, moe_params, moe_tokens, moe_ref, card)
    del moe_ref
    moe_fwd, moe_dq, moe_dkv = phase_moe_train(moe_cfg, moe_params, batches)

    begin("5 (timings)")
    times = phase_timings(gen, cfg, params, batches[0], card)
    bwd_times = phase_bwd_timings(gen, card)
    phase_train_timings(cfg, params, batches[0], card)
    phase_train_profile(cfg, params, batches[0], card)
    decode_times = phase_decode_timings(gen, card)
    phase_serving_timings(cfg, params, prompt, graph_step_ms, card)
    phase_forward_timing(moe_cfg, moe_params, batches[0], card, "MoE forward")
    phase_train_timings(moe_cfg, moe_params, batches[0], card)
    phase_train_profile(moe_cfg, moe_params, batches[0], card)
    phase_serving_timings(moe_cfg, moe_params, prompt, moe_graph_ms, card)
    del moe_params, params
    clear_graphs()  # phases 6-9 start processes that share the card's memory
    begin("6 (the handoff)")
    handoff_launches, handoff_ready_ms = phase_handoff(card)
    begin("7 and 8 (dp x tp and expert parallelism, then sequence and pipeline "
                 "parallelism, in one world of 4 ranks sharing the card)")
    sharded_launches, seq_pipe_launches = phase_parallel(card)
    begin("9 (the mesh-growing hot-add and the multichip dryrun, ranks sharing the card)")
    grow_launches = phase_grow(card)
    dryrun_launches = phase_dryrun(card)
    begin("10 (the hot-mount on the card)")
    mount_report = phase_mount(card, kernel_build_s)
    begin("11 (the hot-mount through the master)")
    mount_launches, master_live = phase_master(card, mount_report, handoff_ready_ms)
    begin("12 (the cgroup v2 device controller)")
    v2_launches = phase_cgroup_v2(card)
    begin("13 (tracing, audit and failpoints on a live hot-mount)")
    phase_obs(card, master_live)
    begin("14 (the worker's durability on a live hot-mount)")
    durability_launches = phase_durability(card)
    begin("15 (the master's store through an API outage on a live hot-mount)")
    degraded_launches = phase_degraded(card, master_live)
    begin("16 (sharded masters and the warm pool on a live hot-mount)")
    pool_launches = phase_shard_pool(card, master_live)
    begin("17 (the fleet planes on a live hot-mount)")
    fleet_launches, fleet_pass_ms = phase_fleet(card, master_live)
    begin("18 (health and recovery on a live hot-mount)")
    health_launches = phase_health(card, master_live)
    begin("19 (the elastic controller and the live migration on a live hot-mount)")
    migrate_launches = phase_elastic_migrate(card, master_live)
    begin("20 (the capacity plane and a metered share of the card's GPU)")
    share_launches = phase_capacity_share(card, master_live, fleet_pass_ms)
    begin("21 (the autoscaler on a live hot-mount)")
    autoscale_launches = phase_autoscale(card)
    begin("22 (the operator's CLI against the live stack)")
    cli_launches = phase_cli(card, master_live)
    begin("23 (the reference's jitted programs as cached CUDA graphs)")
    graph_launches = phase_graphs(card)
    sharded = {k: sharded_launches[k] + seq_pipe_launches[k] + grow_launches[k]
               + dryrun_launches[k] for k in sharded_launches}

    begin("the kernels line")
    nat = mount_report["native"]
    print("native layer (no GPU kernel; phase 10): " + json.dumps({
        "card": card, "build_s": nat["build_s"], "compiled": nat["compiled"],
        "nsexec": {"source": "gpumounter_tpu_torch/native/nsexec.cpp",
                   "replaces": "gpumounter_tpu_torch/nsutil/nsexec.py in a new interpreter",
                   "entry_ms": nat["entry_ms"], "plain_entry_ms": nat["plain_entry_ms"]},
        "native_lib": {"source": "gpumounter_tpu_torch/native/gpumounter_native.cpp",
                       "replaces": "scan_proc_for_device_plain",
                       "scan_ms": nat["scan_ms"], "plain_scan_ms": nat["plain_scan_ms"],
                       "pids": nat["pids"]}}), flush=True)
    print(f"launches on the main paths: flash_fwd {launches} (forward) + "
          f"{prefill_launches} (prefill) + {train_fwd} (training), flash_decode "
          f"{decode_launches}, flash_bwd dq {train_dq} and dk/dv {train_dkv} (training); "
          f"MoE paths: flash_fwd {moe_launches} (forward) + {moe_prefill} (prefill) + "
          f"{moe_fwd} (training), flash_decode {moe_decode}, flash_bwd dq {moe_dq} and dk/dv "
          f"{moe_dkv}; moe_ffn vs moe_ffn_plain bf16 max abs err {moe_ffn_err:.3g}; the "
          f"handoff phase (its children and the uninterrupted runs): {handoff_launches}; "
          f"the sharded phase (every rank's sharded steps): {sharded_launches}; the "
          f"seq/pipeline phase (every rank's dp x sp and pipeline steps): {seq_pipe_launches}; "
          f"the grow phase (every rank's steps in both worlds): {grow_launches}; the dryrun "
          f"(every rank's sharded steps): {dryrun_launches}; the hot-mount's tenant children "
          f"(phase 11: on the UUID the HTTP add mounted, and the slice's on the UUID /addslice "
          f"mounted): flash_fwd {mount_launches}; the "
          f"cgroup v2 round trip's tenant (phase 12): flash_fwd {v2_launches}; the replayed "
          f"GPU's tenant (phase 14): flash_fwd {durability_launches}; the GPU added after the "
          f"read partition's heal (phase 15): flash_fwd {degraded_launches}; the first pooled "
          f"GPU's tenant (phase 16): flash_fwd {pool_launches}; the fleet phase's tenant "
          f"(phase 17): flash_fwd {fleet_launches}; the forward that holds the card under "
          f"the canary (phase 18): flash_fwd {health_launches}; the migrated tenant's two "
          f"ends (phase 19): flash_fwd {migrate_launches}; the metered share's tenant child "
          f"(phase 20): flash_fwd {share_launches}; the autoscaled tenant's windows (phase 21): "
          f"flash_fwd {autoscale_launches}; the tenant on the GPU the CLI mounted (phase 22): "
          f"flash_fwd {cli_launches}; the cached graphs' runs (phase 23): {graph_launches}",
          flush=True)
    held = PHASE3_LOGITS["tenants"]
    print(f"tenant forwards held against the plain-attention forward and bit-equal to phase "
          f"3's logits: {sum(held)} of {len(held)}", flush=True)
    print(f"chip_smoke: phases 1-23 took {time.perf_counter() - t0:.1f} s, the kernels' build "
          f"included [{card}]", flush=True)
    bwd_source = "gpumounter_tpu_torch/ops/csrc/flash_bwd.cu"
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "gpumounter_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "gpumounter_tpu/ops/flash_attention.py:84",
        "launches": (launches + prefill_launches + train_fwd + moe_launches + moe_prefill
                     + moe_fwd + handoff_launches["flash_fwd"] + sharded["flash_fwd"]
                     + mount_launches + v2_launches + durability_launches
                     + degraded_launches + pool_launches + fleet_launches
                     + health_launches + migrate_launches + share_launches
                     + autoscale_launches + cli_launches + graph_launches["flash_fwd"]),
        "max_abs_err": max_abs_err, **times}, {
        "name": "flash_bwd_dq", "route": "cuda", "source": bwd_source,
        "replaces": "gpumounter_tpu/ops/flash_attention.py:182",
        "launches": (train_dq + moe_dq + handoff_launches["dq"] + sharded["dq"]
                     + graph_launches["dq"]),
        "max_abs_err": bwd_errs[0], **bwd_times["dq"]}, {
        "name": "flash_bwd_dkv", "route": "cuda", "source": bwd_source,
        "replaces": "gpumounter_tpu/ops/flash_attention.py:236",
        "launches": (train_dkv + moe_dkv + handoff_launches["dkv"] + sharded["dkv"]
                     + graph_launches["dkv"]),
        "max_abs_err": bwd_errs[1], **bwd_times["dkv"]}, {
        "name": "flash_decode", "route": "cuda",
        "source": "gpumounter_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "gpumounter_tpu/ops/flash_decode.py:48",
        "launches": (decode_launches + moe_decode + handoff_launches["flash_decode"]
                     + graph_launches["flash_decode"]),
        "max_abs_err": decode_err,
        **decode_times}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
