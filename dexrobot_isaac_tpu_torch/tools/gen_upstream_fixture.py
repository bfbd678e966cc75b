"""Generate the upstream-format MJCF test fixture from the vendored model (the
port of `tools/gen_upstream_fixture.py`).

    python -m dexrobot_isaac_tpu_torch.tools.gen_upstream_fixture <out.xml>

The vendored MJCF (`gen_dexhand_mjcf.mjcf_xml()`, from the port's
`models/dexhand021.py`) is written in flat generated form (every attribute
inline, radians, no assets). Upstream `dexrobot_mujoco` hand files use the
full MJCF feature set instead: <compiler angle="degree" autolimits meshdir>,
an <asset> block of link meshes, nested <default class=...> hierarchies with
per-class joint and geom attributes, body `childclass`, and visual geoms
(class "visual": contype=0 conaffinity=0, mesh or primitive) apart from the
collision geoms. This rewrites the vendored model into that shape with
identical physics, byte for byte the committed
`tests/fixtures/dexhand021_upstream_format.xml`, into the path the caller
names (the JAX tool writes that file itself).
"""

from __future__ import annotations

import os
import sys
import xml.etree.ElementTree as ET

import numpy as np

from dexrobot_isaac_tpu_torch.tools.gen_dexhand_mjcf import mjcf_xml


def upstream_tree() -> ET.ElementTree:
    """The upstream-format rewrite of the vendored MJCF."""
    tree = ET.ElementTree(ET.fromstring(mjcf_xml()))
    root = tree.getroot()

    # compiler: degree mode + autolimits + meshdir (upstream convention)
    comp = root.find("compiler")
    comp.set("angle", "degree")
    comp.set("autolimits", "true")
    comp.set("meshdir", "meshes")

    # asset block with mesh declarations referenced by the visual geoms
    asset = ET.Element("asset")
    for mesh in ("palm", "finger_link"):
        ET.SubElement(asset, "mesh", name=mesh, file=f"{mesh}.stl")
    root.insert(1, asset)

    # default-class hierarchy carrying the joint/geom attributes the flat
    # file repeats inline
    default = ET.Element("default")
    d_base = ET.SubElement(default, "default", {"class": "base_joint"})
    ET.SubElement(
        d_base, "joint",
        damping="20", armature="0.050000000000000003", limited="true",
    )
    d_fing = ET.SubElement(default, "default", {"class": "finger_joint"})
    ET.SubElement(d_fing, "joint", damping="1", armature="0.002")
    d_vis = ET.SubElement(default, "default", {"class": "visual"})
    ET.SubElement(
        d_vis, "geom", contype="0", conaffinity="0", group="2"
    )
    d_col = ET.SubElement(default, "default", {"class": "collision"})
    ET.SubElement(d_col, "geom", group="3", type="sphere")
    root.insert(1, default)

    for body in root.iter("body"):
        name = body.get("name", "")
        # base bodies keep explicit classes; finger roots set childclass so
        # descendants inherit (exercises childclass propagation)
        if name.endswith("_1") and name.startswith("r_f_link"):
            body.set("childclass", "finger_joint")
        for joint in body.findall("joint"):
            jn = joint.get("name", "")
            if jn.startswith("AR"):
                joint.set("class", "base_joint")
            # finger joints rely on childclass + autolimits
            for k in ("damping", "armature", "limited"):
                if k in joint.attrib:
                    del joint.attrib[k]
            if joint.get("type", "hinge") != "slide":
                rng = [float(x) for x in joint.get("range").split()]
                joint.set(
                    "range",
                    " ".join(repr(float(np.rad2deg(v))) for v in rng),
                )
        for geom in body.findall("geom"):
            geom.set("class", "collision")
            if geom.get("type") == "sphere":
                del geom.attrib["type"]  # from the collision class default

    # the palm: quat -> euler degrees (exercises degree conversion) and a
    # visual mesh + a visual primitive alongside the collision spheres
    for body in root.iter("body"):
        if body.get("name") == "right_hand_base":
            del body.attrib["quat"]
            body.set("euler", "0 90 0")
            ET.SubElement(
                body, "geom", {"class": "visual", "type": "mesh",
                               "mesh": "palm"},
            )
            ET.SubElement(
                body, "geom", {"class": "visual", "type": "box",
                               "pos": "0.012 0.005 0.045",
                               "size": "0.015 0.045 0.045"},
            )
        if body.get("name", "").startswith("r_f_link"):
            ET.SubElement(
                body, "geom", {"class": "visual", "type": "mesh",
                               "mesh": "finger_link"},
            )

    ET.indent(tree)
    return tree


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 2
    out = argv[0]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    upstream_tree().write(out, xml_declaration=True)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
