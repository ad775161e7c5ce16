"""A small protobuf wire codec: varints and length-delimited fields, enough
for the messages the port reads and writes (io/checkpoint.py).  It takes
the place of a generated `schema_pb2` and of the `google.protobuf` runtime,
which the port does not import."""

VARINT, FIXED64, BYTES, FIXED32 = 0, 1, 2, 5
_MASK64 = (1 << 64) - 1


def put_varint(out, value):
    """Append `value` (an int below 2**64; a negative one in two's
    complement, as int64 fields go on the wire) to the bytearray `out`."""
    value &= _MASK64
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def put_varint_field(out, number, value):
    put_varint(out, (number << 3) | VARINT)
    put_varint(out, int(value))


def put_bytes_field(out, number, data):
    put_varint(out, (number << 3) | BYTES)
    put_varint(out, len(data))
    out += data


def get_varint(data, pos):
    """(value, next position) of the varint at data[pos]."""
    value = shift = 0
    while True:
        if pos >= len(data) or shift > 63:
            raise ValueError('truncated or overlong varint')
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value & _MASK64, pos
        shift += 7


def signed64(value):
    """An int64 field's varint as a signed int."""
    return value - (1 << 64) if value >> 63 else value


def fields(data):
    """Yield (field number, wire type, value) over a serialized message:
    an int for varint and fixed fields, bytes for length-delimited ones."""
    pos = 0
    while pos < len(data):
        tag, pos = get_varint(data, pos)
        number, kind = tag >> 3, tag & 7
        if kind == VARINT:
            value, pos = get_varint(data, pos)
        elif kind == BYTES:
            size, pos = get_varint(data, pos)
            value = bytes(data[pos:pos + size])
            if len(value) != size:
                raise ValueError('truncated field %d' % number)
            pos += size
        elif kind in (FIXED64, FIXED32):
            size = 8 if kind == FIXED64 else 4
            value = int.from_bytes(data[pos:pos + size], 'little')
            pos += size
        else:
            raise ValueError('unsupported wire type %d' % kind)
        yield number, kind, value


def repeated_varints(kind, value):
    """The values one occurrence of a repeated varint field holds: one when
    it is unpacked, any number when it is packed into a bytes field."""
    if kind == VARINT:
        return [value]
    out = []
    pos = 0
    while pos < len(value):
        v, pos = get_varint(value, pos)
        out.append(v)
    return out
