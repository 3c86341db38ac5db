"""Interactive SQL shell — role of the reference's heavysql
(SQLFrontend/heavysql.cpp): REPL with backslash commands, embedded or
client/server mode.

The port of heavydb_tpu/cli.py.  The embedded mode runs on CUDA unless it
is given `--device cpu`.

Usage:
    python -m heavydb_tpu_torch.cli                    # in-memory embedded
    python -m heavydb_tpu_torch.cli --data /path       # persistent embedded
    python -m heavydb_tpu_torch.cli --device cpu       # embedded on the CPU
    python -m heavydb_tpu_torch.cli --connect host:port
"""

from __future__ import annotations

import argparse
import time


HELP = """\
\\h           this help
\\t           list tables
\\d <table>   describe table
\\timing      toggle timing output
\\memory_summary   engine memory summary
\\status      server status / sessions
\\u           list users
\\roles       list roles
\\copy <file> <table>   import a local file
\\version     server version
\\q           quit
"""


class Shell:
    def __init__(self, args):
        self.timing = True
        if args.connect:
            from heavydb_tpu_torch.client.client import Connection

            host, _, port = args.connect.partition(":")
            self.conn = Connection(host or "127.0.0.1", int(port or 6274))
            self.mode = "remote"
        else:
            import heavydb_tpu_torch as hdt

            self.db = hdt.connect(args.data, device=args.device)
            self.mode = "embedded"

    def run_sql(self, sql: str):
        t0 = time.time()
        if self.mode == "remote":
            rs = self.conn.sql(sql)
            rows = rs.rows()
            fields = rs.fields
        else:
            rs = self.db.sql(sql)
            if rs is None:
                rows, fields = [], []
            else:
                rows = rs.rows()
                fields = rs.fields
        ms = (time.time() - t0) * 1e3
        self.print_table(fields, rows)
        if self.timing:
            print(f"({len(rows)} rows, {ms:.1f} ms)")

    @staticmethod
    def print_table(fields, rows, max_rows=100):
        if not fields:
            return
        shown = rows[:max_rows]
        cells = [[_fmt(v) for v in r] for r in shown]
        widths = [
            max(len(f), *(len(c[i]) for c in cells)) if cells else len(f)
            for i, f in enumerate(fields)
        ]
        line = " | ".join(f.ljust(w) for f, w in zip(fields, widths))
        print(line)
        print("-" * len(line))
        for c in cells:
            print(" | ".join(v.ljust(w) for v, w in zip(c, widths)))
        if len(rows) > max_rows:
            print(f"... ({len(rows) - max_rows} more rows)")

    def backslash(self, cmd: str):
        parts = cmd.split()
        c = parts[0]
        if c == "\\h":
            print(HELP)
        elif c == "\\q":
            raise EOFError
        elif c == "\\t":
            if self.mode == "remote":
                for t in self.conn.get_tables():
                    print(t)
            else:
                for t in self.db.catalog.list_tables():
                    print(t)
        elif c == "\\d" and len(parts) > 1:
            self.run_sql(f"DESCRIBE {parts[1]}")
        elif c == "\\timing":
            self.timing = not self.timing
            print(f"timing {'on' if self.timing else 'off'}")
        elif c == "\\memory_summary":
            if self.mode == "remote":
                print(self.conn.get_memory())
            else:
                tables = {
                    name: self.db.catalog.get_table(name).num_rows
                    for name in self.db.catalog.list_tables()
                }
                print({"tables": tables,
                       "kernels": len(self.db.executor.kernel_cache)})
        elif c == "\\version":
            from heavydb_tpu_torch.version import __version__

            print(__version__)
        elif c == "\\status":
            if self.mode == "remote":
                print(self.conn.get_status())
            else:
                self.run_sql("SHOW USER SESSIONS")
        elif c == "\\u":
            self.run_sql("SHOW USERS")
        elif c == "\\roles":
            self.run_sql("SHOW ROLES")
        elif c == "\\copy" and len(parts) > 2:
            # reference heavysql \\copy: client-side file import
            self.run_sql(f"COPY {parts[2]} FROM '{parts[1]}'")
        else:
            print(f"unknown command {c}; \\h for help")

    def repl(self):
        buf = []
        try:
            import readline  # noqa: F401  (history/editing)
        except ImportError:
            pass
        while True:
            prompt = "heavytpu> " if not buf else "      ..> "
            try:
                line = input(prompt)
            except (EOFError, KeyboardInterrupt):
                print()
                break
            if not line.strip():
                continue
            if not buf and line.lstrip().startswith("\\"):
                try:
                    self.backslash(line.strip())
                except EOFError:
                    break
                except Exception as e:
                    print(f"error: {e}")
                continue
            buf.append(line)
            if line.rstrip().endswith(";"):
                sql = "\n".join(buf)
                buf = []
                try:
                    self.run_sql(sql)
                except Exception as e:
                    print(f"error: {type(e).__name__}: {e}")


def _fmt(v):
    if v is None:
        return "NULL"
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)


def main():
    ap = argparse.ArgumentParser(description="heavydb_tpu_torch SQL shell")
    ap.add_argument("--data", default=None, help="persistent data directory")
    ap.add_argument("--connect", default=None, help="host:port of server")
    ap.add_argument("-c", "--command", default=None, help="run one statement")
    ap.add_argument("--device", default=None,
                    help="embedded mode's torch device (default: CUDA; 'cpu' to "
                         "run on the CPU)")
    args = ap.parse_args()
    if not args.connect:
        from heavydb_tpu_torch.server.server import device_or_exit

        args.device = device_or_exit(args.device)
    sh = Shell(args)
    if args.command:
        sh.run_sql(args.command)
        return
    print("heavydb_tpu_torch shell — \\h for help, \\q to quit")
    sh.repl()


if __name__ == "__main__":
    main()
