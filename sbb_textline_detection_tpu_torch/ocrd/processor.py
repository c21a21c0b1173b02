"""OCR-D processor of the port (counterpart of
sbb_textline_detection_tpu/ocrd/processor.py; upstream ocrd_cli.py:29-141).

`OcrdSbbTextlineDetectorRecognize` plugs the port's detector into an OCR-D
workspace: for each input page it renders the page image (filtering
cropped/binarized/grayscale-normalized derivatives exactly like the
reference, ocrd_cli.py:66-69), runs the detection cascade in process on
the card (TextlineDetector.process_image on the numpy image), and merges
Border / ReadingOrder / TextRegions into the workspace PAGE file with
coordinate adaptation (ocrd/merge.py).

The `ocrd` framework is an optional dependency: importing this module
works without it; constructing the processor or invoking the CLI without
it raises a clear error. The processor runs on `device` (default `cuda`)
and nowhere else: without a card, loading the models raises.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

OCRD_TOOL_PATH = os.path.join(os.path.dirname(__file__), "ocrd-tool.json")


def _load_ocrd():
    try:
        import ocrd
        import ocrd_modelfactory
        import ocrd_models
        import ocrd_utils
        return ocrd, ocrd_modelfactory, ocrd_models, ocrd_utils
    except ImportError as e:
        raise ImportError(
            "the `ocrd` framework is not installed in this environment; "
            "the port's standalone CLI (`python -m "
            "sbb_textline_detection_tpu_torch.cli`) and the merge API "
            "(sbb_textline_detection_tpu_torch.ocrd.merge) work without "
            "it") from e


def ocrd_tool() -> dict:
    with open(OCRD_TOOL_PATH) as f:
        return json.load(f)


class OcrdSbbTextlineDetectorRecognize:
    """OCR-D Processor facade. Mirrors upstream ocrd_cli.py:29-141."""

    def __init__(self, workspace, input_file_grp: str, output_file_grp: str,
                 parameter: Optional[dict] = None, config=None,
                 device="cuda", **kwargs):
        """`config`: optional PipelineConfig override (tests / non-default
        deployments); None = DEFAULT_CONFIG, the reference behavior.
        `device`: the torch device the models load on."""
        _load_ocrd()
        self.workspace = workspace
        self.input_file_grp = input_file_grp
        self.output_file_grp = output_file_grp
        self.parameter = parameter or {}
        self._config = config
        self.device = device
        self._detector = None

    def _get_detector(self, model_dir: str):
        if self._detector is None:
            from sbb_textline_detection_tpu_torch.core.config import (
                DEFAULT_CONFIG)
            from sbb_textline_detection_tpu_torch.models.runner import (
                ModelBundle)
            from sbb_textline_detection_tpu_torch.pipeline.detector import (
                TextlineDetector)
            cfg = self._config or DEFAULT_CONFIG
            models = ModelBundle.from_dir(model_dir, cfg.runtime,
                                          device=self.device,
                                          model_names=cfg.model_names)
            self._detector = TextlineDetector(models, cfg)
        return self._detector

    def process(self):
        import xml.etree.ElementTree as ET

        _, ocrd_modelfactory, ocrd_models, ocrd_utils = _load_ocrd()
        from sbb_textline_detection_tpu_torch.ocrd import merge

        log = ocrd_utils.getLogger(
            "processor.OcrdSbbTextlineDetectorRecognize")
        model_dir = self.parameter["model"]
        detector = self._get_detector(model_dir)

        for n, input_file in enumerate(self.workspace.mets.find_files(
                fileGrp=self.input_file_grp)):
            page_id = input_file.pageId or input_file.ID
            log.info("INPUT FILE %i / %s", n, input_file)
            file_id = ocrd_utils.make_file_id(input_file,
                                              self.output_file_grp)
            os.makedirs(self.output_file_grp, exist_ok=True)

            pcgts = ocrd_modelfactory.page_from_file(
                self.workspace.download_file(input_file))
            page = pcgts.get_Page()
            page_image, page_coords, _ = self.workspace.image_from_page(
                page, page_id,
                feature_filter="cropped,binarized,grayscale_normalized")

            # In-process detection: numpy image -> PAGE-XML tree.
            img = np.asarray(page_image.convert("RGB"))
            result = detector.process_image(img, f"{file_id}.png")

            pcgts.set_pcGtsId(file_id)
            target_root = ET.fromstring(
                ocrd_models.ocrd_page.to_xml(pcgts).encode("utf-8"))
            merge.merge_detection_into_page(
                target_root, result.xml_tree.getroot(),
                transform=np.asarray(page_coords["transform"]))

            # processing-step provenance (reference `self.add_metadata`,
            # ocrd_cli.py:132)
            tool = ocrd_tool()
            name = next(iter(tool["tools"]))
            merge.add_processing_step_metadata(
                target_root, executable=name, version=tool["version"],
                step=tool["tools"][name]["steps"][0],
                parameters=self.parameter)

            content = ET.tostring(target_root, encoding="unicode")
            self.workspace.add_file(
                ID=file_id,
                file_grp=self.output_file_grp,
                pageId=page_id,
                mimetype="application/vnd.prima.page+xml",
                local_filename=os.path.join(self.output_file_grp,
                                            file_id) + ".xml",
                content=content,
            )


def ocrd_sbb_textline_detector_tpu_torch(*args, **kwargs):
    """click CLI shim (`ocrd-sbb-textline-detector-tpu-torch`), wrapping
    the processor with ocrd's standard CLI machinery when available."""
    ocrd, *_ = _load_ocrd()
    from ocrd.decorators import ocrd_cli_wrap_processor

    return ocrd_cli_wrap_processor(OcrdSbbTextlineDetectorRecognize,
                                   *args, **kwargs)
