"""A minimal stand-in for the OCR-D framework: the modules `ocrd`,
`ocrd.decorators`, `ocrd_modelfactory`, `ocrd_models` (with
`ocrd_models.ocrd_page`) and `ocrd_utils`, providing exactly the calls
that the processors of both packages make, over a workspace of in-memory
page scans. It imports neither JAX nor the port, so that the tests and
chip_smoke.py can share it.

    ws = StubWorkspace(out_dir, [("PHYS_1", scan, None),
                                 ("PHYS_2", scan2, (y0, x0, h, w))])
    with installed():
        Processor(ws, "OCR-D-IMG", "OCR-D-SEG", {"model": d}).process()

A page given a crop box (y0, x0, h, w) is served as that crop of its scan,
with the page transform of a translation by (-x0, -y0) (absolute -> page
coordinates), as a workspace does for a page cropped by an earlier step.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import types
import xml.etree.ElementTree as ET

import numpy as np

NS = "http://schema.primaresearch.org/PAGE/gts/pagecontent/2019-07-15"
INPUT_GRP = "OCR-D-IMG"


class StubFile:
    def __init__(self, file_id, file_grp, page_id, local_filename,
                 mimetype, image=None):
        self.ID = file_id
        self.fileGrp = file_grp
        self.pageId = page_id
        self.local_filename = local_filename
        self.mimetype = mimetype
        self.image = image

    def __str__(self):
        return f"<StubFile {self.ID} {self.fileGrp}>"


class StubMets:
    def __init__(self):
        self.files = []

    def find_files(self, fileGrp=None):
        return [f for f in self.files
                if fileGrp is None or f.fileGrp == fileGrp]


class StubPcGts:
    """A PAGE document as an ElementTree root."""

    def __init__(self, root):
        self.root = root

    def get_Page(self):
        return self.root.find(f"{{{NS}}}Page")

    def set_pcGtsId(self, pc_id):
        self.root.set("pcGtsId", pc_id)


class StubWorkspace:
    """`pages`: (page_id, scan uint8 (h, w, 3), crop box or None)."""

    def __init__(self, directory, pages):
        self.directory = directory
        self.mets = StubMets()
        self.crops = {}
        self.added = []
        for i, (page_id, scan, box) in enumerate(pages):
            self.mets.files.append(StubFile(
                f"{INPUT_GRP}_{i:04d}", INPUT_GRP, page_id,
                f"{INPUT_GRP}/{page_id}.png", "image/png", scan))
            self.crops[page_id] = box

    def download_file(self, f):
        return f

    def image_from_page(self, page, page_id, feature_filter=""):
        from PIL import Image

        scan = next(f.image for f in self.mets.files if f.pageId == page_id)
        box = self.crops[page_id]
        transform = np.eye(3)
        if box is not None:
            y0, x0, h, w = box
            scan = scan[y0:y0 + h, x0:x0 + w]
            transform[0, 2], transform[1, 2] = -x0, -y0
        return (Image.fromarray(np.ascontiguousarray(scan)),
                {"transform": transform, "features": feature_filter}, {})

    def add_file(self, ID, file_grp, pageId, mimetype, local_filename,
                 content):
        path = os.path.join(self.directory, local_filename)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(content)
        self.mets.files.append(StubFile(ID, file_grp, pageId, path,
                                        mimetype))
        self.added.append(path)


def page_from_file(f):
    """A new PAGE document for an image file: one Page of the scan's size."""
    root = ET.Element(f"{{{NS}}}PcGts")
    md = ET.SubElement(root, f"{{{NS}}}Metadata")
    ET.SubElement(md, f"{{{NS}}}Creator").text = "stub"
    page = ET.SubElement(root, f"{{{NS}}}Page")
    page.set("imageFilename", f.local_filename)
    page.set("imageHeight", str(f.image.shape[0]))
    page.set("imageWidth", str(f.image.shape[1]))
    return StubPcGts(root)


def make_file_id(input_file, output_file_grp):
    ret = input_file.ID.replace(input_file.fileGrp, output_file_grp)
    if ret == input_file.ID:
        ret = f"{output_file_grp}_{input_file.ID}"
    return ret


def _modules():
    ocrd = types.ModuleType("ocrd")
    decorators = types.ModuleType("ocrd.decorators")
    decorators.ocrd_cli_wrap_processor = (
        lambda cls, *a, **k: cls(*a, **k).process())
    ocrd.decorators = decorators
    modelfactory = types.ModuleType("ocrd_modelfactory")
    modelfactory.page_from_file = page_from_file
    models = types.ModuleType("ocrd_models")
    ocrd_page = types.ModuleType("ocrd_models.ocrd_page")
    ocrd_page.to_xml = lambda pcgts: ET.tostring(pcgts.root,
                                                 encoding="unicode")
    models.ocrd_page = ocrd_page
    utils = types.ModuleType("ocrd_utils")
    utils.getLogger = logging.getLogger
    utils.make_file_id = make_file_id
    return {"ocrd": ocrd, "ocrd.decorators": decorators,
            "ocrd_modelfactory": modelfactory, "ocrd_models": models,
            "ocrd_models.ocrd_page": ocrd_page, "ocrd_utils": utils}


@contextlib.contextmanager
def installed():
    """The stub modules in sys.modules for the duration of the block."""
    mods = _modules()
    saved = {name: sys.modules.get(name) for name in mods}
    sys.modules.update(mods)
    try:
        yield
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
