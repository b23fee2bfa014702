"""The client of the program's render service: one call a frame of the
handler ``service.server.RenderService.render`` (through ``render_image``,
which also hands back the developed image its PNG was written from), with
the request that the traffic's settings make: the configuration's scene id,
the width, height, samples a pixel and path depth (the service's empty
request where they are its defaults, as in the demo cell), and the frame's
seed.  The service renders with its own pixels a launch; where the
traffic's settings name one (the benchmark's tests, at a size where the
service's own would make one band of the frame), the service's ``job`` is
wrapped to take it.  Each PNG is read back as a client reads it, its
pixels held to the 8-bit image of the developed one, and deleted; the PNGs
go to a directory of their own under the run's temporary directory."""

from __future__ import annotations

import atexit
import os
import shutil
import struct
import tempfile
import zlib

import numpy as np


def png_pixels(path: str) -> np.ndarray:
    """The pixels u8[H,W,3] of an 8-bit RGB PNG whose rows all carry filter
    type 0, as the service writes them; raises on any other PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(tag + body) != struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: chunk {tag!r} fails its CRC")
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    if (depth, colour, interlace) != (8, 2, 0) or b"IEND" not in chunks:
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace")
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError(f"{path}: a row with a filter")
    return raw[:, 1:].reshape(h, w, 3)


def connect(config: dict, settings: dict, device):
    """-> frame(seed): the developed image f32[H,W,3] of the service's
    response to the request of the render seed ``seed``, on ``device``;
    raises where the service resolves the request to other settings than
    the traffic's (but for the pixels a launch, the service's own where the
    traffic names none), or where the response's PNG does not hold the
    image."""
    import torch

    from gopbrt_tpu_torch.models import render
    from gopbrt_tpu_torch.service.proto import RenderRequest
    from gopbrt_tpu_torch.service.server import RenderService

    out_dir = tempfile.mkdtemp(prefix="portbench-png-")
    atexit.register(shutil.rmtree, out_dir, True)
    want = render.RenderSettings(**settings)
    service = RenderService(device=device, out_dir=out_dir)
    if "chunk_pixels" in settings:
        job = service.job

        def job_in_the_traffics_launches(req):
            scene, camera, got = job(req)
            return scene, camera, got._replace(chunk_pixels=want.chunk_pixels)

        service.job = job_in_the_traffics_launches

    def request(seed: int) -> RenderRequest:
        return RenderRequest(scene_id=config["name"], width=want.width, height=want.height,
                             spp=want.spp, max_depth=want.max_depth, seed=seed)

    got = service.job(request(1))[2]
    if got._replace(chunk_pixels=want.chunk_pixels) != want._replace(seed=1):
        raise ValueError(f"the service resolves the request to other settings than the "
                         f"traffic's: {got} against {want}")

    def frame(seed: int):
        response, img = service.render_image(request(seed))
        px = torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
        if not np.array_equal(png_pixels(response.path), px):
            raise ValueError(f"{response.path}: the PNG does not hold the rendered image")
        os.remove(response.path)
        return img

    return frame
