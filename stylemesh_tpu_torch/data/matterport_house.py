"""Matterport3D ``.house`` file parser.

A copy of ``stylemesh_tpu/data/matterport_house.py`` (the port imports nothing of
the JAX package).

Python equivalent of the reference's C++ MP_Parser
(scripts/matterport/render_uv/src/mp_parser/mp_parser.cpp:157-400):
parses the whitespace-token ASCII ``.house`` scene description (versions 1.0
and current) into levels / regions / panoramas / images, where each image
carries its 4x4 extrinsics, 3x3 intrinsics and resolution — the inputs the
Matterport preprocessing uses to bake UV maps and export poses.
"""

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class MPImage:
    name: str
    camera_index: int
    yaw_index: int
    extrinsics: np.ndarray  # [4, 4]
    intrinsics: np.ndarray  # [3, 3]
    width: int
    height: int
    position: np.ndarray  # [3]
    panorama_index: int

    @property
    def color_filename(self):
        return f"{self.name}_i{self.camera_index}_{self.yaw_index}.jpg"

    @property
    def depth_filename(self):
        return f"{self.name}_d{self.camera_index}_{self.yaw_index}.png"


@dataclasses.dataclass
class MPPanorama:
    name: Optional[str]
    region_index: int
    images: List[MPImage] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MPRegion:
    label: Optional[str]
    level_index: int
    panoramas: List[MPPanorama] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MPHouse:
    name: str
    label: Optional[str]
    regions: List[MPRegion]
    panoramas: List[MPPanorama]
    images: List[MPImage]

    def region_images(self, region_index):
        """All images of a region, iterated panorama by panorama (the order
        the reference renderer uses, mp_renderer.cpp)."""
        out = []
        for pano in self.regions[region_index].panoramas:
            out.extend(pano.images)
        return out


class _Tokens:
    def __init__(self, text):
        self._it = iter(text.split())

    def s(self):
        return next(self._it)

    def i(self):
        return int(next(self._it))

    def f(self):
        return float(next(self._it))

    def skip(self, n):
        for _ in range(n):
            next(self._it)


def parse_house(path) -> MPHouse:
    with open(path) as f:
        t = _Tokens(f.read())

    cmd = t.s()
    if cmd != "ASCII":
        raise ValueError(f"not an ASCII .house file: {path} (got {cmd!r})")
    version = t.s()

    if version == "1.0":
        nsegments = nobjects = ncategories = nportals = 0
        assert t.s() == "H"
        name = t.s()
        label = t.s()
        nimages, npanoramas, nvertices, nsurfaces, nregions, nlevels = (
            t.i(), t.i(), t.i(), t.i(), t.i(), t.i())
        t.skip(6)  # bbox
        t.skip(8)  # reserved
    else:
        assert t.s() == "H"
        name = t.s()
        label = t.s()
        nimages, npanoramas, nvertices, nsurfaces = t.i(), t.i(), t.i(), t.i()
        nsegments, nobjects, ncategories = t.i(), t.i(), t.i()
        nregions, nportals, nlevels = t.i(), t.i(), t.i()
        t.skip(5)  # reserved ints
        t.skip(6)  # bbox
        t.skip(5)  # reserved

    label = None if label == "-" else label

    # levels (only consumed; the reference keeps no fields we need)
    for _ in range(nlevels):
        assert t.s() == "L"
        t.i()  # house index
        t.i()  # dummy
        t.s()  # label
        t.skip(3 + 6)  # position + box
        t.skip(5)

    regions = []
    for i in range(nregions):
        assert t.s() == "R"
        t.i()  # house index
        level_index = t.i()
        t.skip(2)
        rlabel = t.s()
        t.skip(3 + 6)  # position + box
        t.f()  # height
        t.skip(4)
        regions.append(MPRegion(label=None if rlabel == "-" else rlabel,
                                level_index=level_index))

    for _ in range(nportals):
        assert t.s() == "P"
        t.skip(3)  # house, region0, region1
        t.s()  # label
        t.skip(6)  # p0 p1
        t.skip(4)

    for _ in range(nsurfaces):
        assert t.s() == "S"
        t.skip(3)
        t.s()  # label
        t.skip(3 + 3 + 6)  # position normal box
        t.skip(5)

    for _ in range(nvertices):
        assert t.s() == "V"
        t.skip(2)
        t.s()  # label
        t.skip(3 + 3)
        t.skip(3)

    panoramas = []
    for _ in range(npanoramas):
        assert t.s() == "P"
        pname = t.s()
        t.i()  # house index
        region_index = t.i()
        t.i()  # dummy
        t.skip(3)  # position
        t.skip(5)
        pano = MPPanorama(name=None if pname == "-" else pname,
                          region_index=region_index)
        panoramas.append(pano)
        if 0 <= region_index < len(regions):
            regions[region_index].panoramas.append(pano)

    images = []
    for _ in range(nimages):
        assert t.s() == "I"
        t.i()  # house index
        panorama_index = t.i()
        iname = t.s()
        camera_index = t.i()
        yaw_index = t.i()
        extr = np.asarray([t.f() for _ in range(16)],
                          np.float32).reshape(4, 4)
        intr = np.asarray([t.f() for _ in range(9)], np.float32).reshape(3, 3)
        width, height = t.i(), t.i()
        position = np.asarray([t.f() for _ in range(3)], np.float32)
        t.skip(5)
        img = MPImage(name=iname, camera_index=camera_index,
                      yaw_index=yaw_index, extrinsics=extr, intrinsics=intr,
                      width=width, height=height, position=position,
                      panorama_index=panorama_index)
        images.append(img)
        if 0 <= panorama_index < len(panoramas):
            panoramas[panorama_index].images.append(img)

    return MPHouse(name=name, label=label, regions=regions,
                   panoramas=panoramas, images=images)
