"""SSH reverse port forwarding for serving behind NAT.

An own copy of the JAX package's ``io/port_forwarding.py``, verbatim apart
from module paths.

Reference: ``io/http/PortForwarding.scala:16-69`` (jsch ``ssh -R`` tunnels so
an executor-local serving port is reachable from a public host).  Here the
tunnel is the system ``ssh`` client run as a managed subprocess.
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Dict, Optional


class PortForwarding:
    _sessions: Dict[str, subprocess.Popen] = {}

    @staticmethod
    def forward_port_to_remote(username: str, host: str, remote_port: int,
                               local_port: int, key_file: Optional[str] = None,
                               ssh_port: int = 22, extra_args=()) -> str:
        """Open ssh -R remote_port:localhost:local_port; returns session id."""
        if shutil.which("ssh") is None:
            raise RuntimeError("no ssh client available for port forwarding")
        cmd = ["ssh", "-N", "-o", "StrictHostKeyChecking=no",
               "-o", "ExitOnForwardFailure=yes",
               "-R", f"{remote_port}:localhost:{local_port}",
               "-p", str(ssh_port)]
        if key_file:
            cmd += ["-i", key_file]
        cmd += list(extra_args)
        cmd.append(f"{username}@{host}")
        proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        session_id = f"{username}@{host}:{remote_port}->{local_port}"
        PortForwarding._sessions[session_id] = proc
        return session_id

    @staticmethod
    def stop(session_id: str) -> None:
        proc = PortForwarding._sessions.pop(session_id, None)
        if proc is not None:
            proc.terminate()

    @staticmethod
    def stop_all() -> None:
        for sid in list(PortForwarding._sessions):
            PortForwarding.stop(sid)
