"""Qt compatibility layer: real PyQt5 when installed, else headless
pure-Python stand-ins (a copy of the JAX package's ``qt_compat.py``).

The port's GUI (gui.py) is written against exactly this API surface. With
PyQt5 present these names ARE PyQt5's; without it they are minimal
faithful stand-ins (signals, enabled/visible/checked state, combo
items, timer with manual ``fire()``), so the full GUI logic — handler
wiring, parameter collection, queue polling, stop/terminate escalation
— constructs and drives headlessly. That is what lets the GUI be tested
end-to-end in environments without Qt, and lets the same test run
against real offscreen Qt (QT_QPA_PLATFORM=offscreen) when available.
"""

from __future__ import annotations

try:
    from PyQt5.QtCore import QTimer, Qt
    from PyQt5.QtWidgets import (QApplication, QCheckBox, QComboBox,
                                 QFileDialog, QHBoxLayout, QLabel,
                                 QMessageBox, QProgressBar, QPushButton,
                                 QSpinBox, QVBoxLayout, QWidget)
    HAVE_QT = True
except ImportError:  # headless stand-ins
    HAVE_QT = False

    class Signal:
        def __init__(self):
            self._slots = []

        def connect(self, fn):
            self._slots.append(fn)

        def emit(self, *args):
            for fn in list(self._slots):
                fn(*args)

    class _Widget:
        def __init__(self, *args, **kwargs):
            self._visible = True
            self._enabled = True
            self._title = ''

        def setVisible(self, v):
            self._visible = bool(v)

        def isVisible(self):
            return self._visible

        def setEnabled(self, v):
            self._enabled = bool(v)

        def isEnabled(self):
            return self._enabled

        def setWindowTitle(self, t):
            self._title = t

        def windowTitle(self):
            return self._title

        def show(self):
            pass

        def close(self):
            pass

    class QWidget(_Widget):
        pass

    class QLabel(_Widget):
        def __init__(self, text=''):
            super().__init__()
            self._text = text

        def setText(self, t):
            self._text = t

        def text(self):
            return self._text

    class QPushButton(QLabel):
        def __init__(self, text=''):
            super().__init__(text)
            self.clicked = Signal()

        def click(self):
            if self._enabled:
                self.clicked.emit()

    class QCheckBox(QLabel):
        def __init__(self, text=''):
            super().__init__(text)
            self._checked = False
            self.toggled = Signal()

        def isChecked(self):
            return self._checked

        def setChecked(self, v):
            v = bool(v)
            changed = v != self._checked
            self._checked = v
            if changed:
                self.toggled.emit(v)

    class QComboBox(_Widget):
        def __init__(self):
            super().__init__()
            self._items = []
            self._idx = -1
            self.currentTextChanged = Signal()

        def addItems(self, items):
            self._items.extend(items)
            if self._idx < 0 and self._items:
                self._idx = 0
                self.currentTextChanged.emit(self._items[0])

        def clear(self):
            self._items = []
            self._idx = -1

        def count(self):
            return len(self._items)

        def itemText(self, i):
            return self._items[i]

        def currentText(self):
            if 0 <= self._idx < len(self._items):
                return self._items[self._idx]
            return ''

        def setCurrentText(self, t):
            if t in self._items:
                idx = self._items.index(t)
                if idx != self._idx:
                    self._idx = idx
                    self.currentTextChanged.emit(t)

    class QSpinBox(_Widget):
        def __init__(self):
            super().__init__()
            self._lo, self._hi = 0, 99
            self._value = 0

        def setRange(self, lo, hi):
            self._lo, self._hi = lo, hi
            self._value = min(max(self._value, lo), hi)

        def maximum(self):
            return self._hi

        def value(self):
            return self._value

        def setValue(self, v):
            self._value = min(max(int(v), self._lo), self._hi)

    class QProgressBar(_Widget):
        def __init__(self):
            super().__init__()
            self._max = 100
            self._value = 0

        def setMaximum(self, m):
            self._max = m

        def maximum(self):
            return self._max

        def setValue(self, v):
            self._value = v

        def value(self):
            return self._value

    class _Layout:
        def __init__(self, parent=None):
            self.items = []

        def addWidget(self, w):
            self.items.append(w)

        def addLayout(self, l):
            self.items.append(l)

    class QVBoxLayout(_Layout):
        pass

    class QHBoxLayout(_Layout):
        pass

    class QFileDialog:
        @staticmethod
        def getExistingDirectory(parent=None, caption=''):
            return ''

    class QMessageBox:
        messages = []  # (level, title, text) — inspectable by tests

        @classmethod
        def warning(cls, parent, title, text):
            cls.messages.append(('warning', title, text))

        @classmethod
        def critical(cls, parent, title, text):
            cls.messages.append(('critical', title, text))

    class QTimer(_Widget):
        def __init__(self, parent=None):
            super().__init__()
            self.timeout = Signal()
            self._active = False
            self._interval = 0

        def start(self, ms=None):
            if ms is not None:
                self._interval = ms
            self._active = True

        def stop(self):
            self._active = False

        def isActive(self):
            return self._active

        def interval(self):
            return self._interval

        def fire(self):
            """Headless stand-in for one elapsed timer period."""
            if self._active:
                self.timeout.emit()

    class Qt:
        pass

    class QApplication:
        _instance = None

        def __init__(self, argv=None):
            QApplication._instance = self

        @staticmethod
        def instance():
            return QApplication._instance

        @staticmethod
        def processEvents():
            pass

        def exec_(self):
            return 0
