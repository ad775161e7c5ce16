"""Streaming container formats (distributions_tpu.io.stream), the same
bytes on disk:

- `json_stream_dump` / `json_stream_load`: newline-framed json arrays
  ('[' line, one item per line with trailing commas, ']' line)
- `protobuf_stream_dump` / `protobuf_stream_load`: uint32-LE
  length-prefixed binary frames
- transparent .gz / .bz2 compression by filename extension

A C++ fast path for the length-prefixed framing,
`distributions_tpu_torch.io._framing` (native/framing.cc, built by
`python setup.py build_ext --inplace`), is used when it imports, for
uncompressed files; these Python definitions are the always-available
path and the semantics of record.
"""

import bz2
import gzip
import json
import os
import struct

try:
    from distributions_tpu_torch.io import _framing as _native
except ImportError:     # the native extension is optional
    _native = None


def mkdir_p(dirname):
    if dirname and not os.path.exists(dirname):
        os.makedirs(dirname, exist_ok=True)


def open_compressed(filename, mode='r'):
    if 'w' in mode:
        mkdir_p(os.path.dirname(filename))
    if filename.endswith('.bz2'):
        return bz2.open(filename, mode if 'b' in mode else mode + 't')
    elif filename.endswith('.gz'):
        return gzip.open(filename, mode if 'b' in mode else mode + 't')
    else:
        return open(filename, mode)


def json_dump(data, filename, **kwargs):
    with open_compressed(filename, 'w') as f:
        json.dump(data, f, **kwargs)


def json_load(filename):
    with open_compressed(filename, 'r') as f:
        return json.load(f)


def json_costream_dump(filename, **kwargs):
    """Coroutine variant of json_stream_dump: send() items in as they are
    produced; the file stays readable by json_stream_load.  Prime with next() before sending;
    close() finalizes the container.

        co = json_costream_dump('out.json.gz')
        next(co)
        co.send({'a': 1})
        co.close()
    """
    kwargs['separators'] = (',', ':')
    with open_compressed(filename, 'w') as f:
        f.write('[')
        try:
            item = (yield)
            f.write('\n')
            json.dump(item, f, **kwargs)
            while True:
                item = (yield)
                f.write(',\n')
                json.dump(item, f, **kwargs)
        except GeneratorExit:
            pass
        f.write('\n]')


def json_stream_dump(stream, filename, **kwargs):
    kwargs['separators'] = (',', ':')
    stream = iter(stream)
    with open_compressed(filename, 'w') as f:
        f.write('[')
        try:
            item = next(stream)
            f.write('\n')
            json.dump(item, f, **kwargs)
            for item in stream:
                f.write(',\n')
                json.dump(item, f, **kwargs)
        except StopIteration:
            pass
        f.write('\n]')


class json_stream_load(object):
    """Iterate items from a json_stream_dump'd file, one line at a time
    (it relies on the newline framing)."""

    def __init__(self, filename):
        self.fd = open_compressed(filename, 'r')
        line = self.fd.readline(2)
        if line != '[\n':
            raise IOError(
                'Unhandled format for json_stream_load; recreate the file '
                'with json_stream_dump.')

    def __iter__(self):
        return self

    def __next__(self):
        line = self.fd.readline().rstrip(',\n')
        if line == ']':
            self.close()
            raise StopIteration
        return json.loads(line)

    next = __next__

    def close(self):
        self.fd.close()


def protobuf_stream_write(item, fd):
    assert isinstance(item, bytes), item
    fd.write(struct.pack('<I', len(item)))
    fd.write(item)


def protobuf_stream_read(fd):
    size_str = fd.read(4)
    if len(size_str) < 4:
        raise StopIteration
    size = struct.unpack('<I', size_str)[0]
    return fd.read(size)


def _use_native(filename):
    return _native is not None and not filename.endswith(('.gz', '.bz2'))


def protobuf_stream_dump(stream, filename):
    if _use_native(filename):
        _native.stream_dump(list(stream), filename)
        return
    with open_compressed(filename, 'wb') as f:
        for item in stream:
            protobuf_stream_write(item, f)


class protobuf_stream_load(object):
    def __init__(self, filename):
        self._items = self.fd = None
        if _use_native(filename):
            self._items = iter(_native.stream_load(filename))
        else:
            self.fd = open_compressed(filename, 'rb')

    def __iter__(self):
        return self

    def __next__(self):
        if self._items is not None:
            return next(self._items)
        return protobuf_stream_read(self.fd)

    next = __next__

    def close(self):
        if self.fd is not None:
            self.fd.close()
