"""TCP serving front end over the server-mode decoder (counterpart of
edgedict_tpu/serving.py; the same wire protocol, so clients of either
package talk to servers of either).

N concurrent PCM streams multiplex onto MultiStreamDecoder's batch axis:
one chunk step on the device per round for the whole fleet, behind a
dependency-free asyncio TCP protocol.

Wire protocol (little-endian uint32 length prefix, both directions):

  client → server   [len][float32 PCM bytes]: any payload size, 16 kHz
                    mono; len==0 marks end-of-stream.  The length prefix's
                    TOP BIT marks the payload as int16 PCM instead (half the
                    bytes on the wire; a server built with pcm='int16' keeps
                    the samples int16 through its buffers and the
                    host→device copy, and the device scales them,
                    features.pcm_to_float).
  server → client   [len][type byte + UTF-8 text]: type b'+' appends the
                    text to the transcript (greedy deltas); type b'='
                    REPLACES the whole transcript.  len==0 is the final
                    flush (the connection closes after it).  A client
                    connecting while every slot is busy receives "+[busy]"
                    then the flush.

Round semantics: audio is consumed in win_size windows advancing hop_size,
the slicing of StreamingDecoder.decode_wav, so each stream's concatenated
deltas equal the single-stream decoder's text for the same audio (streams
are independent on the batch axis).  A round dispatches when EVERY attached
stream has a full window buffered (lockstep, deterministic, the default),
or, with `round_timeout` set, when the timeout elapses with at least one
ready stream; streams that missed a timed round are fed silence for that
window.
"""

import asyncio
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np


async def _send(writer, payload: bytes, timeout=10.0):
    """Bounded send: True on success.  A client that stops reading (drain
    blocked past `timeout`) is aborted so it can never head-of-line-block
    the round loop for everyone else."""
    try:
        writer.write(struct.pack('<I', len(payload)) + payload)
        await asyncio.wait_for(writer.drain(), timeout)
        return True
    except (ConnectionError, asyncio.TimeoutError):
        try:
            writer.transport.abort()
        except Exception:
            pass
        return False


_I16_FLAG = 1 << 31


async def _recv(reader, max_len):
    """One length-prefixed payload → (payload, is_int16); (None, False) on
    disconnect or a length beyond `max_len` (protocol abuse — readexactly
    would buffer it all).  Bit 31 of the prefix flags int16 PCM."""
    try:
        (ln,) = struct.unpack('<I', await reader.readexactly(4))
        i16 = bool(ln & _I16_FLAG)
        ln &= _I16_FLAG - 1
        if ln > max_len:
            return None, False
        return (await reader.readexactly(ln) if ln else b''), i16
    except (asyncio.IncompleteReadError, ConnectionError):
        return None, False


class StreamServer:
    """Serve a MultiStreamDecoder over TCP: greedy deltas are appended;
    with `full_hypothesis=True` the round's text replaces the transcript
    instead (the protocol's b'=' messages).

    Slot lifecycle: connect → lowest free slot (the decoder's per-stream
    state was reset when the slot was freed); end-of-stream or disconnect
    → remaining full windows decode, the flush payload is sent,
    reset_stream(slot) frees it for the next client.
    """

    def __init__(self, decoder, host='127.0.0.1', port=0,
                 round_timeout=None, full_hypothesis=False,
                 max_payload=1 << 24, max_buffer_seconds=600.0,
                 pcm='float32'):
        self.dec = decoder
        self.host, self.port = host, port
        self.round_timeout = round_timeout
        self.full_hypothesis = full_hypothesis
        self.max_payload = max_payload
        self.max_buffer_samples = int(max_buffer_seconds * 16000)
        # pcm='int16': samples stay int16 from the wire through the round
        # buffers and the host→device copy (the chunk step scales them —
        # features.pcm_to_float); float32 payloads from mixed clients are
        # quantized at ingest (exact for anything sourced from 16-bit PCM)
        assert pcm in ('float32', 'int16'), pcm
        self._dtype = np.int16 if pcm == 'int16' else np.float32
        n = decoder.n
        self._buf = [np.zeros(0, self._dtype) for _ in range(n)]
        self._writer = [None] * n
        self._eof = [False] * n
        self._done = [None] * n
        self._last = [''] * n
        self._cond = None
        self._server = None
        self._round_task = None
        # ONE thread owns every device dispatch (decode + per-slot reset):
        # serializes state mutation and keeps the event loop free
        self._exec = ThreadPoolExecutor(max_workers=1)
        self.rounds = 0

    # -- lifecycle ---------------------------------------------------------

    async def start(self):
        self._cond = asyncio.Condition()
        self._server = await asyncio.start_server(
            self._client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._round_task = asyncio.get_running_loop().create_task(
            self._round_loop())

    async def stop(self):
        self._round_task.cancel()
        try:
            await self._round_task
        except asyncio.CancelledError:
            pass
        self._server.close()
        try:
            # 3.12's wait_closed can block past the last handler (it also
            # waits on the serve_forever future, which plain start() never
            # creates) — bound it; the listener is already closed
            await asyncio.wait_for(self._server.wait_closed(), 5)
        except asyncio.TimeoutError:
            pass
        self._exec.shutdown(wait=True)

    async def serve_forever(self):
        await self.start()
        async with self._server:
            await self._server.serve_forever()

    # -- per-connection reader --------------------------------------------

    async def _client(self, reader, writer):
        async with self._cond:
            slot = next((i for i in range(self.dec.n)
                         if self._writer[i] is None), None)
            if slot is not None:
                self._writer[slot] = writer
                self._eof[slot] = False
                self._buf[slot] = np.zeros(0, self._dtype)
                self._done[slot] = asyncio.Event()
                self._last[slot] = ''
        if slot is None:
            await _send(writer, b'+[busy]')
            await _send(writer, b'')
            writer.close()
            return
        try:
            # fresh per-stream state AT ATTACH: every chunk round advances
            # all N decoder rows, so a freed slot has been hearing silence
            # since its last client — and the reset must land (same
            # single-thread executor as decode → ordered) before this
            # client's first window can reach a round, which it does
            # because audio is only read after this await
            await asyncio.get_running_loop().run_in_executor(
                self._exec, self.dec.reset_stream, slot)
            while True:
                payload, i16 = await _recv(reader, self.max_payload)
                if not payload:                 # EOF marker or disconnect
                    break
                if len(payload) % (2 if i16 else 4):
                    break                       # misaligned: protocol error
                pcm = np.frombuffer(payload,
                                    np.int16 if i16 else np.float32)
                pcm = self._to_server_dtype(pcm)
                async with self._cond:
                    if (len(self._buf[slot]) + len(pcm)
                            > self.max_buffer_samples):
                        break                   # backpressure cap: drop
                    self._buf[slot] = np.concatenate(
                        [self._buf[slot], pcm])
                    self._cond.notify_all()
        finally:
            # ALWAYS hand the slot to the round loop for flush+free —
            # an unexpected exception must not leak an attached slot
            # (in lockstep mode that would wedge rounds for everyone)
            async with self._cond:
                self._eof[slot] = True
                self._cond.notify_all()
        await self._done[slot].wait()           # round loop flushed slot
        writer.close()

    def _to_server_dtype(self, pcm):
        """Wire samples → the server's buffer dtype."""
        if pcm.dtype == self._dtype:
            return pcm
        if self._dtype == np.int16:      # float client on an int16 server
            q = np.round(np.clip(pcm, -1.0, 1.0) * 32768.0)
            return np.clip(q, -32768, 32767).astype(np.int16)
        return pcm.astype(np.float32) / 32768.0   # int16 client, f32 server

    # -- chunk rounds ------------------------------------------------------

    async def _round_loop(self):
        win, hop = self.dec.win_size, self.dec.hop_size
        loop = asyncio.get_running_loop()
        while True:
            async with self._cond:
                fed, deadline = None, None
                while fed is None:
                    await self._finalize_drained()
                    attached = [i for i in range(self.dec.n)
                                if self._writer[i] is not None]
                    ready = [i for i in attached
                             if len(self._buf[i]) >= win]
                    now = loop.time()
                    if ready and len(ready) == len(attached):
                        fed = ready                      # lockstep round
                    elif ready and self.round_timeout is not None:
                        # a FIXED deadline from the first ready stream —
                        # re-arming per notification would let a chatty
                        # fleet starve partial rounds forever
                        if deadline is None:
                            deadline = now + self.round_timeout
                        if now >= deadline:
                            fed = ready
                        else:
                            try:
                                await asyncio.wait_for(self._cond.wait(),
                                                       deadline - now)
                            except asyncio.TimeoutError:
                                pass
                    else:
                        deadline = None
                        await self._cond.wait()
                frames = np.zeros((self.dec.n, win), self._dtype)
                for i in fed:
                    frames[i] = self._buf[i][:win]
                    self._buf[i] = self._buf[i][hop:]
                # snapshot the recipients WITH the frames: a client that
                # attaches mid-decode must never receive text derived from
                # the previous occupant's carried state
                senders = list(self._writer)
            try:
                texts = await loop.run_in_executor(
                    self._exec, self.dec.decode, frames)
            except Exception as e:               # noqa: BLE001 — keep serving
                print(f'serving: decode round failed: {e!r}', flush=True)
                await asyncio.sleep(0.5)         # no tight error loop
                continue
            self.rounds += 1
            # every snapshotted stream may have progressed — in a timed
            # round the non-fed ones consumed a silence window (their text
            # is still theirs to hear)
            for i in range(self.dec.n):
                w = senders[i]
                if w is None or self._writer[i] is not w:
                    continue                     # detached (or reattached)
                if self.full_hypothesis:
                    if texts[i] == self._last[i]:
                        continue
                    self._last[i] = texts[i]
                    msg = b'=' + texts[i].encode()
                elif texts[i]:
                    msg = b'+' + texts[i].encode()
                else:
                    continue
                await _send(w, msg)
            async with self._cond:
                await self._finalize_drained()

    async def _finalize_drained(self):
        """Flush + free every eof'd slot with no full window left (state
        reset happens at the next attach).  Caller holds self._cond."""
        win = self.dec.win_size
        for i in range(self.dec.n):
            if (self._writer[i] is not None and self._eof[i]
                    and len(self._buf[i]) < win):
                await _send(self._writer[i], b'')
                self._writer[i] = None
                self._done[i].set()


def stream_client(host, port, audio, chunk_samples=4096, int16=False):
    """Blocking reference client: stream PCM in `chunk_samples` pieces,
    send end-of-stream, apply text messages ('+' append, '=' replace)
    until the flush payload.  Returns the final transcript ('[busy]' when
    rejected).  int16=True sends int16 PCM with the flag bit — half the
    wire bytes (float input is quantized; int16 input passes through)."""
    import socket

    if int16:
        if audio.dtype != np.int16:
            audio = np.clip(np.round(np.clip(audio, -1.0, 1.0) * 32768.0),
                            -32768, 32767).astype(np.int16)
        flag = _I16_FLAG
    else:
        audio = np.asarray(audio, np.float32)
        flag = 0
    with socket.create_connection((host, port)) as sock:
        for off in range(0, len(audio), chunk_samples):
            piece = audio[off:off + chunk_samples].tobytes()
            sock.sendall(struct.pack('<I', len(piece) | flag) + piece)
        sock.sendall(struct.pack('<I', 0))
        return _drain_text(sock)


def _drain_text(sock):
    text = ''
    buf = b''
    while True:
        while len(buf) < 4:
            data = sock.recv(65536)
            if not data:
                return text
            buf += data
        (ln,) = struct.unpack('<I', buf[:4])
        buf = buf[4:]
        while len(buf) < ln:
            data = sock.recv(65536)
            if not data:
                return text
            buf += data
        if ln == 0:
            return text
        kind, payload = buf[:1], buf[1:ln].decode()
        buf = buf[ln:]
        text = text + payload if kind == b'+' else payload
