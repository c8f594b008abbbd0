"""v2 master client (parity: python/paddle/v2/master/client.py:29 — the
ctypes wrapper over libpaddle_master.so).

Here the fault-tolerant master is the port's TCP service
(`distributed.master`); this module keeps the v2 call shape:

    import paddle_tpu_torch.v2 as paddle
    c = paddle.master.client(addr="host:port", buf_size=...)
    c.set_dataset(["part-0.recordio", ...])
    while True:
        record, err = c.next_record()
        if err: break     # pass end
"""
from __future__ import annotations

from ..distributed import MasterClient as _MasterClient


class client:
    """v2 client API over the distributed MasterClient."""

    def __init__(self, addr: str = None, buf_size: int = 0,
                 etcd_endpoints: str = None, timeout_sec: int = 30,
                 buf_count: int = 0, port_file: str = None):
        """Connect by addr "host:port", or discover the port from the file
        a MasterServer(port_file=...) wrote (the etcd-free analog of the
        reference's etcd discovery)."""
        if etcd_endpoints is not None:
            raise NotImplementedError(
                "etcd discovery is replaced by direct addressing (addr=) "
                "or MasterServer port_file discovery (port_file=)")
        if addr is None:
            if port_file is None:
                raise ValueError("pass addr='host:port' or port_file=...")
            with open(port_file) as f:
                addr = f"127.0.0.1:{int(f.read().strip())}"
        host, port = addr.rsplit(":", 1)
        if int(port) <= 0:
            raise ValueError(f"invalid master port in addr {addr!r}")
        self._c = _MasterClient(host, int(port), timeout_sec=timeout_sec)

    def set_dataset(self, paths):
        self._c.set_dataset(list(paths))

    def next_record(self):
        """(record, error_code): (bytes, 0) or (None, -2) at pass end —
        the v2 wrapper's convention."""
        rec = self._c.next_record()
        if rec is None:
            return None, -2
        return rec, 0

    def paddle_start_get_records(self, pass_id=0):
        pass                                   # compatibility no-op

    def release(self):
        self._c.close()

    close = release
