"""Time one message of N bytes across a multiprocessing pipe, sent whole
and sent in 16 MiB frames (as ``repro_torch.core.ranks`` sends a rank's
job and reply): the receiver's wall from the first byte asked to the
last byte held.

    python3 tools/pipe_frames.py 300000000 [1700000000 ...]

Prints one line a size and form.  Run each size under a ``timeout``: on
some hosts the whole message takes minutes.
"""
import multiprocessing as mp
import sys
import time

FRAME = 1 << 24


def _child(conn, n, framed):
    blob = bytes(n)
    if framed:
        view = memoryview(blob)
        k = -(-n // FRAME)
        conn.send_bytes(k.to_bytes(8, "little"))
        for i in range(k):
            conn.send_bytes(view[i * FRAME:(i + 1) * FRAME])
    else:
        conn.send_bytes(blob)


def main():
    ctx = mp.get_context("spawn")
    for n in map(int, sys.argv[1:]):
        for framed in (True, False):
            ours, theirs = ctx.Pipe()
            p = ctx.Process(target=_child, args=(theirs, n, framed))
            p.start()
            t0 = time.perf_counter()
            if framed:
                buf = bytearray()
                for _ in range(int.from_bytes(ours.recv_bytes(), "little")):
                    buf += ours.recv_bytes()
            else:
                buf = ours.recv_bytes()
            print(f"{n} bytes {'in frames' if framed else 'whole'}: "
                  f"{time.perf_counter() - t0:.4f} s ({len(buf)} received)",
                  flush=True)
            p.join()


if __name__ == "__main__":
    main()
