"""Job submission SDK.

Parity target: reference python/ray/job_submission (JobSubmissionClient,
JobStatus) backed by the dashboard job manager
(dashboard/modules/job/job_manager.py:60, submit_job:423). Here the
controller owns the job table and a node agent runs the entrypoint as a
driver subprocess with `RT_ADDRESS` injected so `ray_tpu_torch.init()`
inside the job attaches to the same cluster.

Counterpart: ray_tpu/job_submission/__init__.py (copied).
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional

from ray_tpu_torch._private import rpc


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = frozenset({SUCCEEDED, FAILED, STOPPED})

    @classmethod
    def is_terminal(cls, status: str) -> bool:
        return status in cls.TERMINAL


class JobInfo(dict):
    """Dict view of a job table row (submission_id, entrypoint, status,
    message, node_id, start_time, end_time, metadata, runtime_env)."""

    @property
    def status(self) -> str:
        return self["status"]

    @property
    def submission_id(self) -> str:
        return self["submission_id"]


class JobSubmissionClient:
    """Submit and manage driver jobs against a running cluster.

    `address` is "host:port" of the controller (what `ray-tpu-torch start
    --head` prints); defaults to $RT_ADDRESS, then to the current driver's
    cluster when `ray_tpu_torch.init()` already ran in this process.
    """

    def __init__(self, address: Optional[str] = None):
        if address is None:
            address = os.environ.get("RT_ADDRESS")
        if address is None:
            from ray_tpu_torch._private.worker import global_worker

            w = global_worker()
            if w is not None:
                address = f"{w.controller_addr[0]}:{w.controller_addr[1]}"
        if address is None:
            raise ValueError("no address: pass one, set RT_ADDRESS, or init() first")
        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self._io = rpc.EventLoopThread(name="job-client")
        self._conn: Optional[rpc.Connection] = None

    def _call(self, method: str, timeout: float = 30.0, **kw):
        async def _go():
            if self._conn is None or self._conn.closed:
                self._conn = await rpc.connect(*self._addr)
                await self._conn.call("register", kind="client",
                                      worker_id=f"jobclient-{os.getpid()}",
                                      address=None)
            return await self._conn.call(method, **kw)

        return self._io.run(_go(), timeout=timeout)

    # ------------------------------------------------------------- API
    def submit_job(self, *, entrypoint: str, submission_id: Optional[str] = None,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[dict] = None) -> str:
        rep = self._call("submit_job", entrypoint=entrypoint,
                         submission_id=submission_id, runtime_env=runtime_env,
                         metadata=metadata)
        return rep["submission_id"]

    def get_job_status(self, submission_id: str) -> str:
        return self._call("get_job", submission_id=submission_id)["job"]["status"]

    def get_job_info(self, submission_id: str) -> JobInfo:
        return JobInfo(self._call("get_job", submission_id=submission_id)["job"])

    def list_jobs(self) -> list[JobInfo]:
        return [JobInfo(j) for j in self._call("list_jobs")["jobs"]]

    def stop_job(self, submission_id: str) -> bool:
        return bool(self._call("stop_job", submission_id=submission_id)["stopped"])

    def _read_logs_from(self, submission_id: str, offset: int) -> tuple[bytes, int]:
        """Read to EOF. The agent caps each reply (JOB_LOG_CHUNK_BYTES) and
        marks clipped ones `truncated: true`; loop on the marker so a large
        log arrives whole without ever riding one unbounded RPC frame."""
        chunks = []
        while True:
            rep = self._call("job_logs", submission_id=submission_id, offset=offset)
            data = bytes(rep["data"])
            offset = rep["offset"]
            if data:
                chunks.append(data)
            if not rep.get("truncated", bool(data)):
                # Marker-less legacy replies fall back to read-until-empty.
                return b"".join(chunks), offset

    def get_job_logs(self, submission_id: str) -> str:
        data, _ = self._read_logs_from(submission_id, 0)
        return data.decode(errors="replace")

    def tail_job_logs(self, submission_id: str,
                      poll_interval_s: float = 0.25) -> Iterator[str]:
        """Yield log chunks until the job reaches a terminal state."""
        offset = 0
        while True:
            data, offset = self._read_logs_from(submission_id, offset)
            if data:
                yield data.decode(errors="replace")
            status = self.get_job_status(submission_id)
            if JobStatus.is_terminal(status):
                tail, offset = self._read_logs_from(submission_id, offset)
                if tail:
                    yield tail.decode(errors="replace")
                return
            time.sleep(poll_interval_s)

    def wait_until_finished(self, submission_id: str, timeout: float = 300.0,
                            poll_interval_s: float = 0.2) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if JobStatus.is_terminal(status):
                return status
            time.sleep(poll_interval_s)
        raise TimeoutError(f"job {submission_id} still running after {timeout}s")

    def close(self):
        if self._conn is not None:
            conn = self._conn

            async def _bye():
                await conn.close()

            try:
                self._io.run(_bye(), timeout=5)
            except Exception:
                pass
        self._io.stop()
