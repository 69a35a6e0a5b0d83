"""Event-driven serving harness.

Runs the REAL LiveServe control plane — ``UrgencyScheduler``, ``KVManager``,
``Preloader``, ``RuntimeMonitor`` execute verbatim — against a virtual
clock. Stage execution time comes from the pipeline cost model
(DESIGN.md §2: only the data plane's wall-clock is modelled; every policy
decision is made by the actual implementation under test).

Structure
  SessionDriver   client behavior: VAD speech, playback, barge-in, turns
  StageEngine     continuous batching loop per AR stage (thinker, talker)
  Vocoder         FIFO chunk server delivering audio fragments
  Orchestrator    stage graph + barge-in abort propagation (paper §3)
  Simulation      wires everything, collects Metrics
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.kv_manager import KVManager
from repro_torch.core.monitor import RuntimeMonitor
from repro_torch.core.preload import Preloader
from repro_torch.core.scheduler import (FCFSScheduler, RoundBudget,
                                        SchedulerConfig, UrgencyScheduler)
from repro_torch.core.session import (Phase, Request, RequestState,
                                      Session, Turn)
from repro_torch.serving.costmodel import PipelineSpec, StageSpec
from repro_torch.serving.metrics import Metrics, TurnRecord
from repro_torch.serving.simclock import EventQueue, VirtualClock
from repro_torch.serving.workload import WorkloadConfig, generate

__all__ = ["Metrics", "TurnRecord", "Simulation", "StageEngine",
           "Vocoder", "run_sim"]


# ======================================================================
class Vocoder:
    """Lightweight FIFO chunk server (colocated CNN module)."""

    def __init__(self, sim, chunk_cost_s: float):
        self.sim = sim
        self.chunk_cost_s = chunk_cost_s
        self.busy_until = 0.0

    def submit(self, session_id: str, turn_index: int, tokens: int,
               last: bool) -> None:
        now = self.sim.clock.now()
        start = max(now, self.busy_until)
        done = start + self.chunk_cost_s
        self.busy_until = done
        self.sim.events.push(
            done, lambda: self.sim.on_audio_chunk(session_id, turn_index,
                                                  tokens, last))


# ======================================================================
class StageEngine:
    """Continuous batching loop with pluggable ordering policy."""

    def __init__(self, sim, spec: StageSpec, scheduler, kv: KVManager):
        self.sim = sim
        self.spec = spec
        self.scheduler = scheduler
        self.kv = kv
        self.requests: Dict[int, Request] = {}
        self.busy = False
        self.working_blocks: Dict[int, int] = {}

    # ------------------------------------------------------------ queue
    def submit(self, req: Request) -> None:
        self.requests[req.req_id] = req
        if self.kv is not None:
            self.kv.pin(req.session_id)
        self.kick()

    def abort(self, req: Request) -> None:
        req.state = RequestState.ABORTED
        self.requests.pop(req.req_id, None)
        self._release_working(req)

    def _release_working(self, req: Request) -> None:
        blocks = self.working_blocks.pop(req.req_id, 0)
        if self.kv is not None and blocks:
            self.kv.release_working(blocks)

    def finish(self, req: Request) -> None:
        req.state = RequestState.FINISHED
        req.finish_time = self.sim.clock.now()
        self.requests.pop(req.req_id, None)
        self._release_working(req)

    # ------------------------------------------------------------ rounds
    def _ready(self, now: float) -> List[Request]:
        out = []
        for r in self.requests.values():
            if not r.is_live():
                continue
            if not self.sim.can_progress(self.spec.name, r, now):
                continue
            out.append(r)
        return out

    def kick(self) -> None:
        if self.busy:
            return
        now = self.sim.clock.now()
        if self._ready(now):
            self._start_round()

    def _start_round(self) -> None:
        now = self.sim.clock.now()
        ready = self._ready(now)
        if not ready:
            return
        avail = (self.kv.capacity - self.kv.working_blocks
                 if self.kv is not None else 1 << 30)
        budget = RoundBudget(token_budget=self.spec.token_budget,
                             free_kv_blocks=avail,
                             max_batch=self.spec.max_batch,
                             block_size=self.spec.block_size)
        decision = self.scheduler.schedule(ready, budget, now)
        if not decision.batch:
            wake = self.scheduler.hold_wake_s(decision)
            if wake is not None:
                # everything pace-held: re-kick when the earliest buffer
                # drains back to the pacing threshold (playback is 1 s/s)
                self.sim.events.push_in(wake, self.kick)
            return
        admitted, prefill_tokens, decode_n = [], 0, 0
        for r in decision.batch:
            chunk = decision.chunks[r.req_id]
            if self.kv is not None:
                have = self.working_blocks.get(r.req_id, 0)
                work_tokens = r.prefilled + r.generated
                need = self.kv.blocks_of(work_tokens + chunk) - have
                if need > 0 and not self.kv.try_allocate_working(need, now):
                    continue                    # preempted this round
                if need > 0:
                    self.working_blocks[r.req_id] = have + need
            r.state = RequestState.RUNNING
            admitted.append((r, chunk))
            if r.phase == Phase.PREFILL and not r.done_prefill:
                prefill_tokens += chunk
            else:
                decode_n += 1
        if not admitted:
            return
        c = self.spec.cost
        dur = (c.round_overhead_s + c.prefill_token_s * prefill_tokens
               + c.decode_token_s * decode_n)
        self.busy = True
        self.sim.events.push_in(dur, lambda: self._finish_round(admitted))
        if self.kv is not None:
            self.kv.log_residency(now)

    def _finish_round(self, admitted) -> None:
        now = self.sim.clock.now()
        for r, chunk in admitted:
            if r.state == RequestState.ABORTED:
                continue                        # barge-in discarded the work
            if r.phase == Phase.PREFILL and not r.done_prefill:
                r.prefilled += chunk
                if r.done_prefill:
                    r.phase = Phase.DECODE
            else:
                r.generated += 1
                if r.first_output_time is None:
                    r.first_output_time = now
                self.sim.on_token(self.spec.name, r)
            if r.state != RequestState.ABORTED:
                r.state = RequestState.WAITING
        self.busy = False
        self.sim.on_round_done(self.spec.name)
        self.kick()


# ======================================================================
class Simulation:
    """Full pipeline: clients -> thinker -> talker -> vocoder -> playback."""

    def __init__(self, pipeline: PipelineSpec, workload: WorkloadConfig, *,
                 policy: str = "liveserve", sched_cfg=None,
                 kv_policy: Optional[str] = None,
                 preload: Optional[bool] = None,
                 eviction_index: str = "heap",
                 seed: int = 0):
        """policy: liveserve | fcfs (+ kv_policy/preload overrides for
        ablations). Baselines: fcfs+lru = vLLM-Omni w/ offload,
        fcfs+none = vLLM-Omni-wo."""
        self.pipeline = pipeline
        self.clock = VirtualClock()
        self.events = EventQueue(self.clock)
        self.monitor = RuntimeMonitor(self.clock)
        self.metrics = Metrics()
        self.policy = policy
        live = policy == "liveserve"
        kv_policy = kv_policy if kv_policy is not None else (
            "next_use" if live else "lru")
        use_preload = preload if preload is not None else live

        self.sessions: Dict[str, Session] = {}
        self.turn_records: Dict[tuple, TurnRecord] = {}
        self.live_requests: Dict[tuple, Request] = {}   # (sid, stage)
        self.talker_limit: Dict[str, int] = {}          # sid -> avail tokens
        self.thinker_target: Dict[str, int] = {}
        self.audio_outstanding: Dict[str, int] = {}     # undelivered chunks
        self.barge_scheduled: Dict[tuple, bool] = {}

        self._turn_started: set = set()
        self._done_sessions: set = set()
        self.engines: Dict[str, StageEngine] = {}
        self.kvs: Dict[str, KVManager] = {}
        for st in pipeline.stages:
            kv = KVManager(
                capacity_blocks=st.kv_capacity_blocks,
                block_size=st.block_size,
                bytes_per_token=st.kv_bytes_per_token,
                monitor=self.monitor, policy=kv_policy,
                index_mode=eviction_index,
                pcie_gb_s=pipeline.pcie_gb_s, clock=self.clock)
            cfg = sched_cfg or SchedulerConfig()
            if live:
                sched = UrgencyScheduler(
                    cfg, self.monitor, stage=st.name,
                    buffer_estimator=self._make_buffer_est(st.name),
                    kv_occupancy=kv.occupancy,
                    kv_of_request=lambda r, _kv=kv:
                        float(_kv.session(r.session_id).total_blocks
                              + _kv.blocks_of(r.prefilled + r.generated)))
            else:
                sched = FCFSScheduler(self.monitor, stage=st.name)
            self.kvs[st.name] = kv
            self.engines[st.name] = StageEngine(self, st, sched, kv)
        self.preloaders = {
            name: Preloader(kv, self.monitor,
                            encode_delay_s=pipeline.encode_delay_s,
                            enabled=use_preload)
            for name, kv in self.kvs.items()}
        self.vocoder = Vocoder(self, pipeline.vocoder_chunk_s)

        self.workload_cfg = workload
        self._pending_sessions = generate(workload)
        self._active = 0
        self._started = 0
        self.seed = seed

    # ---------------------------------------------------------- helpers
    def _make_buffer_est(self, stage: str):
        apt = self.pipeline.audio_per_token_s
        spt = self.pipeline.speech_per_text

        def est(req: Request) -> Optional[float]:
            buf = self.monitor.playback_buffer_s(req.session_id)
            if buf is None:
                return None
            if stage == "thinker":
                talker = self.live_requests.get((req.session_id, "talker"))
                consumed = talker.generated if talker else 0
                backlog = max(0, req.generated * spt - consumed) * apt
                return buf + backlog
            # talker: client buffer + undelivered vocoder chunks
            chunks = self.audio_outstanding.get(req.session_id, 0)
            return buf + chunks * self.pipeline.vocoder_chunk * apt
        return est

    def rec(self, sid: str, turn: int) -> TurnRecord:
        key = (sid, turn)
        if key not in self.turn_records:
            self.turn_records[key] = TurnRecord(session_id=sid,
                                                turn_index=turn)
            self.metrics.turns.append(self.turn_records[key])
        return self.turn_records[key]

    # ---------------------------------------------------------- lifecycle
    def run(self, *, until: float = 3600.0) -> Metrics:
        cc = self.workload_cfg.concurrency
        n0 = cc if cc else len(self._pending_sessions)
        for _ in range(min(n0, len(self._pending_sessions))):
            self._launch_next_session()
        self.events.run(until=until)
        self.metrics.sim_end = self.clock.now()
        return self.metrics

    def _launch_next_session(self) -> None:
        if not self._pending_sessions:
            return
        s = self._pending_sessions.pop(0)
        self.sessions[s.session_id] = s
        self._active += 1
        self._started += 1
        start = (self.clock.now() if self.workload_cfg.concurrency
                 else max(self.clock.now(), s.arrival_time))
        self.events.push(start, lambda: self._speech_start(s, 0))

    def _session_done(self, s: Session) -> None:
        if s.session_id in self._done_sessions:
            return
        self._done_sessions.add(s.session_id)
        self._active -= 1
        self.metrics.completed_sessions += 1
        for kv in self.kvs.values():
            kv.unpin(s.session_id, self.clock.now())
        if self.workload_cfg.concurrency:
            self._launch_next_session()

    # ---------------------------------------------------------- turns
    def _speech_start(self, s: Session, turn_idx: int) -> None:
        if turn_idx >= len(s.turns):
            self._session_done(s)
            return
        if (s.session_id, turn_idx) in self._turn_started:
            return                        # stale duplicate (barge-in race)
        self._turn_started.add((s.session_id, turn_idx))
        s.current_turn = turn_idx
        turn = s.turns[turn_idx]
        now = self.clock.now()
        self.monitor.on_turn_start(s.session_id, turn_idx)
        dur = turn.speech_end            # speech duration stored there
        self.monitor.on_speech_start(s.session_id, expected_dur_s=dur)
        for pre in self.preloaders.values():
            pre.on_speech_start(s.session_id, now)
        self.events.push_in(dur, lambda: self._speech_end(s, turn_idx))

    def _speech_end(self, s: Session, turn_idx: int) -> None:
        self.monitor.on_speech_end(s.session_id)
        self.events.push_in(self.pipeline.encode_delay_s,
                            lambda: self._turn_arrival(s, turn_idx))

    def _turn_arrival(self, s: Session, turn_idx: int) -> None:
        now = self.clock.now()
        turn = s.turns[turn_idx]
        rec = self.rec(s.session_id, turn_idx)
        rec.speech_end = now - self.pipeline.encode_delay_s
        # KV reload on the critical path (or warm preload hit)
        stall = self.preloaders["thinker"].on_turn_ready(s.session_id, now)
        stall += self.preloaders["talker"].on_turn_ready(s.session_id, now)
        rec.reload_stall_s = stall
        rec.reload_off_path_s = sum(
            pre.pop_split(s.session_id)[1]
            for pre in self.preloaders.values())
        prompt = turn.prompt_len
        recompute = self.kvs["thinker"].recompute_tokens(s.session_id)
        if recompute:
            prompt += recompute          # 'none' policy re-prefills history
            kv = self.kvs["thinker"].session(s.session_id)
            kv.total_blocks -= kv.dram_blocks
            kv.discarded = False
        text_target = max(2, turn.response_tokens
                          // self.pipeline.speech_per_text)
        req = Request(session_id=s.session_id, stage="thinker",
                      turn_index=turn_idx, arrival_time=now + stall,
                      prompt_len=prompt, context_len=s.context_tokens,
                      max_new_tokens=text_target,
                      audio_per_token_s=self.pipeline.audio_per_token_s)
        self.thinker_target[s.session_id] = text_target
        self.live_requests[(s.session_id, "thinker")] = req
        if stall > 0:
            self.events.push_in(
                stall, lambda: self.engines["thinker"].submit(req))
        else:
            self.engines["thinker"].submit(req)

    # ---------------------------------------------------------- coupling
    def can_progress(self, stage: str, req: Request, now: float) -> bool:
        if now + 1e-12 < req.arrival_time:
            return False
        if req.phase == Phase.PREFILL and not req.done_prefill:
            return True
        if req.generated >= req.max_new_tokens:
            return False
        if stage == "talker":
            return req.generated < self.talker_limit.get(req.session_id, 0)
        return True

    def on_token(self, stage: str, req: Request) -> None:
        sid = req.session_id
        now = self.clock.now()
        s = self.sessions[sid]
        turn = s.turns[req.turn_index]
        rec = self.rec(sid, req.turn_index)
        if stage == "thinker":
            if rec.text_ttft is None:
                rec.text_ttft = now - rec.speech_end
            spt = self.pipeline.speech_per_text
            chunk = self.pipeline.thinker_chunk
            done = req.generated >= req.max_new_tokens
            ready_text = (req.generated if done
                          else (req.generated // chunk) * chunk)
            self.talker_limit[sid] = (turn.response_tokens if done else
                                      min(turn.response_tokens,
                                          ready_text * spt))
            if (sid, "talker") not in self.live_requests \
                    and ready_text > 0:
                t_req = Request(
                    session_id=sid, stage="talker",
                    turn_index=req.turn_index, arrival_time=now,
                    prompt_len=0, context_len=s.context_tokens,
                    max_new_tokens=turn.response_tokens,
                    audio_per_token_s=self.pipeline.audio_per_token_s)
                t_req.phase = Phase.DECODE
                self.live_requests[(sid, "talker")] = t_req
                self.engines["talker"].submit(t_req)
            else:
                self.engines["talker"].kick()
            if done:
                self.engines["thinker"].finish(req)
                self._commit_stage_kv("thinker", sid, req)
        elif stage == "talker":
            rec.talker_generated += 1
            vchunk = self.pipeline.vocoder_chunk
            done = req.generated >= req.max_new_tokens
            if req.generated % vchunk == 0 or done:
                pending = req.generated % vchunk or vchunk
                self.audio_outstanding[sid] = \
                    self.audio_outstanding.get(sid, 0) + 1
                self.vocoder.submit(sid, req.turn_index, pending, done)
            if done:
                self.engines["talker"].finish(req)
                self._commit_stage_kv("talker", sid, req)

    def _commit_stage_kv(self, stage: str, sid: str, req: Request) -> None:
        s = self.sessions[sid]
        kv = self.kvs[stage]
        total = req.context_len + req.prefilled + req.generated
        self.engines[stage]._release_working(req)
        kv.commit_turn(sid, total, self.clock.now())
        if stage == "thinker":
            s.context_tokens = total

    def on_round_done(self, stage: str) -> None:
        # cross-engine wakeups: talker may have become schedulable
        for e in self.engines.values():
            e.kick()

    # ---------------------------------------------------------- audio
    def on_audio_chunk(self, sid: str, turn_idx: int, tokens: int,
                       last: bool) -> None:
        now = self.clock.now()
        rec = self.rec(sid, turn_idx)
        if rec.barged:
            return                        # audio after abort is dropped
        self.audio_outstanding[sid] = max(
            0, self.audio_outstanding.get(sid, 0) - 1)
        dur = tokens * self.pipeline.audio_per_token_s
        if rec.ttfp is None:
            rec.ttfp = now - rec.speech_end
            s = self.sessions[sid]
            turn = s.turns[turn_idx]
            if turn.barge_in and not self.barge_scheduled.get(
                    (sid, turn_idx)):
                self.barge_scheduled[(sid, turn_idx)] = True
                self.events.push_in(
                    turn.barge_cut_s,
                    lambda: self._barge_in(sid, turn_idx))
        self.monitor.on_audio(sid, dur)
        rec.audio_delivered_s += dur
        if last:
            self._response_complete(sid, turn_idx)

    def _response_complete(self, sid: str, turn_idx: int) -> None:
        now = self.clock.now()
        rec = self.rec(sid, turn_idx)
        if rec.barged:
            return
        self.monitor.on_response_complete(sid)
        v = self.monitor.view(sid)
        rec.max_gap_s = v.playback.gap_s and v.playback.max_gap_s or 0.0
        rec.n_gaps = v.playback.n_gaps
        rec.gen_span_s = now - rec.speech_end - (rec.ttfp or 0.0)
        rec.completed = True
        rec.finish_time = now
        self.live_requests.pop((sid, "thinker"), None)
        self.live_requests.pop((sid, "talker"), None)
        # playback continues; next turn after it drains + think time
        s = self.sessions[sid]
        drain = v.playback.buffer_s(now)
        if turn_idx + 1 < len(s.turns):
            self.events.push_in(
                drain + s.think_time_s,
                lambda: self._speech_start(s, turn_idx + 1))
        else:
            self.events.push_in(drain, lambda: self._session_done(s))

    # ---------------------------------------------------------- barge-in
    def _barge_in(self, sid: str, turn_idx: int) -> None:
        now = self.clock.now()
        s = self.sessions[sid]
        if s.current_turn > turn_idx or sid in self._done_sessions:
            return                        # a later turn already started
        rec = self.rec(sid, turn_idx)
        if rec.completed and self.monitor.view(sid).playback.buffer_s(
                now) <= 0:
            return                        # playback already finished
        rec.barged = True
        v = self.monitor.view(sid)
        heard = v.playback.consumed_s(now)
        rec.audio_heard_s = heard
        heard_tokens = int(heard / self.pipeline.audio_per_token_s)
        rec.talker_wasted = max(0, rec.talker_generated - heard_tokens)
        # abort in-flight work, discard beyond playback point (paper §3)
        for stage in ("thinker", "talker"):
            req = self.live_requests.pop((sid, stage), None)
            if req is not None and req.is_live():
                self.engines[stage].abort(req)
                # KV up to the heard point is kept for the next turn
                if stage == "thinker":
                    kept = req.prefilled + min(
                        req.generated,
                        heard_tokens // self.pipeline.speech_per_text)
                    total = req.context_len + kept
                    self.kvs[stage].commit_turn(sid, total, now)
                    s.context_tokens = total
                else:
                    self.kvs[stage].commit_turn(
                        sid, req.context_len + heard_tokens, now)
        self.monitor.on_barge_in(sid)
        for pre in self.preloaders.values():
            pre.on_speech_start(sid, now)   # barge-in preload trigger
        rec.finish_time = now
        # the interrupting utterance becomes the next turn
        if turn_idx + 1 < len(s.turns):
            self._speech_start(s, turn_idx + 1)
        else:
            self._session_done(s)


# ======================================================================
def run_sim(pipeline: PipelineSpec, workload: WorkloadConfig, *,
            policy: str = "liveserve", until: float = 3600.0,
            **kw) -> Metrics:
    sim = Simulation(pipeline, workload, policy=policy, **kw)
    return sim.run(until=until)
