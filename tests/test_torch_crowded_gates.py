"""The crowded AP gates of JAX ``tests/test_crowded_accuracy.py`` through
the port (CPU), but the base yolov5n's (``tests/test_torch_crowded.py``):
yolov5s, ssd-resnet10 at 300, mtcnn, the crowded yolov5n and the crowded
yolov5s6 at 960, each from its ``card_weights/`` file through the port's
``evaluate_engine_on_wider`` on the port's seed-11 set (held to the
stored digests), at the JAX test's floors and within the stored
tolerance (``ap_tol``) of the JAX CPU engine's AP50 and AP
(``check_crowded``).
"""
import pytest
import torch

from face_detection_and_recognition_tpu_torch.eval import card_weights as CW

EXPECTED = CW.load_expected()
CROWDED = EXPECTED["crowded"]
NETS = sorted(set(CROWDED["nets"]) - {"yolov5n"})


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_set(tmp_path_factory):
    return CW.crowded_set(str(tmp_path_factory.mktemp("crowded")), CROWDED)


@pytest.mark.parametrize("name", NETS)
def test_port_crowded_ap_gate_from_the_file(port_set, name):
    net = CROWDED["nets"][name]
    eng = CW.crowded_engine(CROWDED, EXPECTED["nets"][net["net"]], "cpu")
    m = CW.check_crowded(name, CROWDED, eng, *port_set)
    for k, floor in net["floors"].items():
        assert m[k] >= floor
