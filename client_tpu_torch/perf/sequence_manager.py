"""Sequence-id allocation and per-sequence progress for stateful workloads.

Parity with the reference SequenceManager (reference
src/c++/perf_analyzer/sequence_manager.h:46-132): start id + id range with
wraparound, per-sequence remaining-queries, and sequence-length variation.
The port's copy of client_tpu/perf/sequence_manager.py.
"""

import threading

import numpy as np


class SequenceStatus:
    def __init__(self, seq_id):
        self.seq_id = seq_id
        self.remaining_queries = 0
        self.data_stream_id = 0
        self.step_id = 0


class SequenceManager:
    def __init__(self, start_sequence_id=1, sequence_id_range=2**32 - 1,
                 sequence_length=20, sequence_length_variation=0.0,
                 sequence_length_specified=False, num_streams=1, rng_seed=0):
        self._start = start_sequence_id
        self._range = sequence_id_range
        self._length = sequence_length
        self._variation = sequence_length_variation
        self._length_specified = sequence_length_specified
        self._num_streams = num_streams
        self._rng = np.random.default_rng(rng_seed)
        self._next = start_sequence_id
        self._lock = threading.Lock()
        self._sequences = {}  # slot index -> SequenceStatus

    def _new_sequence_id(self):
        sid = self._next
        self._next += 1
        if self._next >= self._start + self._range:
            self._next = self._start  # wraparound (command_line_parser.h:85-86)
        return sid

    def _sequence_length(self, stream_id, steps_in_stream):
        if not self._length_specified and steps_in_stream > 1:
            # user data defines the natural sequence length
            return steps_in_stream
        if self._variation:
            offset = self._length * self._variation / 100.0
            return max(1, int(self._rng.uniform(
                self._length - offset, self._length + offset
            )))
        return max(1, self._length)

    def begin_sequence(self, slot, steps_per_stream=(1,)):
        """Start a new sequence in the given worker slot; returns its status.

        ``steps_per_stream`` maps data-stream id -> step count so the natural
        sequence length follows the stream the sequence is actually assigned.
        """
        if isinstance(steps_per_stream, int):  # convenience for tests
            steps_per_stream = [steps_per_stream]
        with self._lock:
            status = SequenceStatus(self._new_sequence_id())
            status.data_stream_id = (
                int(self._rng.integers(0, self._num_streams))
                if self._num_streams > 1
                else 0
            )
            steps = (
                steps_per_stream[status.data_stream_id]
                if status.data_stream_id < len(steps_per_stream)
                else 1
            )
            status.remaining_queries = self._sequence_length(
                status.data_stream_id, steps
            )
            status.step_id = 0
            self._sequences[slot] = status
            return status

    def get(self, slot):
        with self._lock:
            return self._sequences.get(slot)

    def advance(self, status):
        """Consume one query; returns (sequence_start, sequence_end)."""
        start = status.step_id == 0
        status.remaining_queries -= 1
        status.step_id += 1
        end = status.remaining_queries <= 0
        return start, end
