"""The benchmark's Redis: a RESP2 server on 127.0.0.1 that speaks AUTH,
GET, SET (with EX) and KEYS, string keys in memory. It runs as a process
of its own and imports no torch, as a Redis server would:

    python3 portbench/respdouble.py --password PW

prints ``127.0.0.1:<port>`` on its first line of standard output and
serves until its standard input closes.

``RespDouble`` is a frozen copy of ``chip_smoke.py:3011-3095``; KEYS is
added so that the benchmark's judge can read every entry back.
"""

from __future__ import annotations

import argparse
import fnmatch
import socket
import sys
import threading


class RespDouble:
    """The smoke's Redis: a RESP2 server on 127.0.0.1 speaking AUTH, GET
    and SET (with EX), string keys in memory. It counts commands by name
    (and SETs carrying EX), never logging an argument."""

    def __init__(self, password: str) -> None:
        self.password = password
        self.data: dict[bytes, bytes] = {}
        self.counts: dict[str, int] = {}
        self.set_ex = 0
        self.refused = 0
        self._lock = threading.Lock()
        self._sock = socket.create_server(("127.0.0.1", 0))
        self.addr = "127.0.0.1:%d" % self._sock.getsockname()[1]
        self._threads = [threading.Thread(target=self._accept, daemon=True)]
        self._threads[0].start()

    def stop(self) -> None:
        self._sock.close()

    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn) -> None:
        buf = b""

        def need(pred):
            nonlocal buf
            while not pred():
                piece = conn.recv(1 << 16)
                if not piece:
                    raise EOFError
                buf += piece

        authed = False
        with conn:
            try:
                while True:
                    need(lambda: b"\r\n" in buf)
                    line, buf = buf.split(b"\r\n", 1)
                    parts = []
                    for _ in range(int(line[1:])):
                        need(lambda: b"\r\n" in buf)
                        hdr, buf = buf.split(b"\r\n", 1)
                        n = int(hdr[1:])
                        need(lambda: len(buf) >= n + 2)
                        parts.append(buf[:n])
                        buf = buf[n + 2:]
                    conn.sendall(self._reply(parts, authed))
                    if parts[0].upper() == b"AUTH":
                        authed = parts[1].decode() == self.password
            except (EOFError, OSError, ValueError):
                return

    def _reply(self, parts: list, authed: bool) -> bytes:
        cmd = parts[0].upper().decode()
        with self._lock:
            self.counts[cmd] = self.counts.get(cmd, 0) + 1
            if cmd == "AUTH":
                if parts[1].decode() == self.password:
                    return b"+OK\r\n"
                self.refused += 1
                return b"-WRONGPASS invalid password\r\n"
            if not authed:
                self.refused += 1
                return b"-NOAUTH Authentication required.\r\n"
            if cmd == "GET":
                value = self.data.get(parts[1])
                return (b"$-1\r\n" if value is None
                        else b"$%d\r\n%s\r\n" % (len(value), value))
            if cmd == "SET":
                self.data[parts[1]] = parts[2]
                if len(parts) >= 5 and parts[3].upper() == b"EX":
                    self.set_ex += 1
                return b"+OK\r\n"
            if cmd == "KEYS":
                keys = [k for k in self.data
                        if fnmatch.fnmatchcase(k.decode("latin-1"),
                                               parts[1].decode("latin-1"))]
                return b"*%d\r\n" % len(keys) + b"".join(
                    b"$%d\r\n%s\r\n" % (len(k), k) for k in keys)
            return b"-ERR unknown command\r\n"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--password", required=True)
    args = parser.parse_args(argv)
    double = RespDouble(args.password)
    print(double.addr, flush=True)
    sys.stdin.read()  # serve until the parent closes our input
    double.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
